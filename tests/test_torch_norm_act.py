"""GroupNorm + scale-shift + SiLU (``causaldiffae_torch/ops/norm_act.py``) on the CPU.

- the plain forward is the eager chain ``GroupNorm32`` ran before the norm
  got its kernel pair, bit for bit, and the module still gives it on the CPU;
- the plain backward formula (the one the backward kernel computes, in fp32)
  matches autograd of the eager chain: in fp32 within fp32 summation noise,
  in bf16 within the bf16 roundings the eager chain's autograd adds at each
  of its steps;
- ``NormAct`` on CPU tensors runs the plain versions both ways;
- a traced forward holds the norm as one op node where the model routes
  through the kernels (bf16 and fp32 alike), and the plain chain elsewhere;
  a traced call that needs a gradient raises;
- ``ops.prepare`` readies nothing where the model takes no kernel, and on
  the CPU builds nothing.

Small shapes; the card's checks are in ``test_torch_cuda.py``.
"""

import pytest
import torch

from causaldiffae_torch.models import GroupNorm32
from causaldiffae_torch.ops import norm_act as ops

# (B, C, spatial, groups): 2-D maps, a token axis (the attention block's norm),
# 16 groups (a tensor-parallel shard's half of 32)
SHAPES = [(2, 64, (6, 6), 32), (3, 32, (16,), 32), (2, 64, (4, 5), 16)]
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(B, C, spatial, dtype, seed=0, scale_shift=True):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, C, *spatial, generator=g) * 1.5 + 0.3).to(dtype)
    w = 1.0 + 0.2 * torch.randn(C, generator=g)
    b = 0.1 * torch.randn(C, generator=g)
    emb = (0.3 * torch.randn(B, 2 * C, generator=g)).to(dtype)
    scale, shift = torch.chunk(emb, 2, dim=-1) if scale_shift else (None, None)
    return x, w, b, scale, shift


def _eager(x, weight, bias, G, eps, scale_shift=None, silu_after=False):
    """``GroupNorm32.forward`` as it was before the kernel pair, verbatim."""
    orig_dtype = x.dtype
    B, C = x.shape[:2]
    x32 = x.float().reshape(B, G, -1)
    mean = x32.mean(dim=-1, keepdim=True)
    msq = (x32 * x32).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(msq - mean * mean + eps)
    y = ((x32 - mean) * inv).reshape(x.shape)
    bshape = (1, C) + (1,) * (x.ndim - 2)
    y = y * weight.reshape(bshape) + bias.reshape(bshape)
    y = y.to(orig_dtype)
    if scale_shift is not None:
        scale, shift = scale_shift
        cshape = (B, C) + (1,) * (x.ndim - 2)
        y = y * (1 + scale.to(orig_dtype).reshape(cshape)) + shift.to(orig_dtype).reshape(cshape)
    if silu_after:
        y = y * torch.sigmoid(y)
    return y


@pytest.mark.parametrize("B,C,spatial,G", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ss,silu", [(True, True), (False, True), (False, False), (True, False)])
def test_plain_forward_is_the_eager_chain(B, C, spatial, G, dtype, ss, silu):
    x, w, b, scale, shift = _inputs(B, C, spatial, dtype, scale_shift=ss)
    want = _eager(x, w, b, G, 1e-5, (scale, shift) if ss else None, silu)
    got = ops.norm_act_plain(x, w, b, G, 1e-5, scale, shift, silu)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    norm = GroupNorm32(C, G)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
        assert torch.equal(norm(x, (scale, shift) if ss else None, silu), want)
    assert torch.equal(ops.norm_act_fwd(x, w, b, G, 1e-5, scale, shift, silu), want)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


# relative L2 distance of the plain formula from autograd of the eager chain
# (read at 0.8e-7-1.3e-7 in fp32 and 1.6e-3-4.6e-3 in bf16 on these inputs):
# fp32, the same function summed in another order; bf16, autograd rounds the
# SiLU's and the scale-shift's gradients to bf16 at each of its ~6 steps
# (up to 2^-9 each) where the formula stays in fp32
REL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("B,C,spatial,G", SHAPES[:2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ss,silu", [(True, True), (False, True), (False, False)])
def test_plain_backward_matches_autograd_of_the_eager_chain(B, C, spatial, G, dtype, ss, silu):
    x, w, b, scale, shift = _inputs(B, C, spatial, dtype, seed=1, scale_shift=ss)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    ss_leaves = [t.clone().requires_grad_(True) for t in (scale, shift)] if ss else [None, None]
    y = _eager(*leaves, G, 1e-5, tuple(ss_leaves) if ss else None, silu)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)).to(dtype)
    y.backward(dy)
    dx, dw, db, dscale, dshift = ops.norm_act_bwd_plain(x, dy, w, b, G, 1e-5, scale, shift, silu)
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    pairs = [(dx, leaves[0].grad), (dw, leaves[1].grad), (db, leaves[2].grad)]
    if ss:
        assert dscale.dtype == dshift.dtype == dtype
        pairs += [(dscale, ss_leaves[0].grad), (dshift, ss_leaves[1].grad)]
    else:
        assert dscale is None and dshift is None
    for got, want in pairs:
        assert _rel(got, want) <= REL[dtype], (_rel(got, want), tuple(want.shape))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ss,silu", [(True, True), (False, False)])
def test_card_bound_holds_the_plain_formula_to_itself(dtype, ss, silu):
    """The card tests' bound (``_norm_reference``): the magnitudes dominate
    the plain formula's values, the formula passes against itself, and a
    kernel one whole channel wrong fails."""
    from _norm_reference import bwd_errors, bwd_magnitudes

    x, w, b, scale, shift = _inputs(2, 64, (6, 6), dtype, seed=10, scale_shift=ss)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(11)).to(dtype)
    stats = ops.norm_act_stats_plain(x, 32, 1e-5)
    plain = ops.norm_act_bwd_plain(x, dy, w, b, 32, 1e-5, scale, shift, silu, stats)
    mags = bwd_magnitudes(x, dy, w, b, scale, shift, silu, *stats)
    assert (plain[3] is None) == (mags[3] is None) == (not ss)
    for p, m in zip(plain, mags):
        if p is not None:
            assert bool((p.float().abs() <= m.reshape(p.shape) * (1 + 1e-5) + 1e-30).all())
    assert all(e is None or e <= 0 for e in bwd_errors(plain, plain, mags))
    wrong = plain[0].clone()
    wrong[:, 5] = -wrong[:, 5]
    assert bwd_errors((wrong, *plain[1:]), plain, mags)[0] > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_function_on_cpu_runs_the_plain_versions(dtype):
    """``NormAct`` on CPU tensors: the eager chain forward, the plain formula
    backward; ``norm_act_bwd`` on the CPU is the plain formula."""
    x, w, b, scale, shift = _inputs(2, 32, (4, 4), dtype, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b, scale, shift)]
    y = ops.NormAct.apply(*leaves, 32, 1e-5, True)
    assert torch.equal(y.detach(), ops.norm_act_plain(x, w, b, 32, 1e-5, scale, shift, True))
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(4)).to(dtype)
    y.backward(dy)
    want = ops.norm_act_bwd_plain(x, dy, w, b, 32, 1e-5, scale, shift, True)
    assert all(torch.equal(t.grad, g) for t, g in zip(leaves, want))
    got = ops.norm_act_bwd(x, dy, w, b, 32, 1e-5, scale, shift, True)
    assert all(torch.equal(a, g) for a, g in zip(got, want))
    y, mean, rstd = ops.norm_act_fwd(x, w, b, 32, 1e-5, scale, shift, True, with_stats=True)
    assert mean.shape == rstd.shape == (2, 32) and mean.dtype == rstd.dtype == torch.float32


def test_norm_op_registration():
    """The no-grad forward is a dispatcher op export can trace
    (``torch.library.opcheck``: schema, fake, dispatch); on the CPU it is the
    plain version on x as it is, laid out as the eager call's output, which
    the fake says too (AOTInductor reads the output by the fake's strides)."""
    x, w, b, scale, shift = _inputs(2, 32, (3, 3), torch.bfloat16, seed=5)
    op = torch.ops.causaldiffae.norm_act_fwd.default
    torch.library.opcheck(op, (x, w, b, scale.contiguous(), shift.contiguous(), 32, 1e-5, True))
    torch.library.opcheck(op, (x, w, b, None, None, 32, 1e-5, False))
    want = ops.norm_act_plain(x, w, b, 32, 1e-5, scale, shift, True)
    assert torch.equal(op(x, w, b, scale, shift, 32, 1e-5, True), want)
    # a compiled graph may hand the op another layout: on the CPU, as the eager path, the
    # eager chain's values and layout on that x, which the fake gives as well: x's own
    # layout at one channel a group, contiguous at two
    from torch._subclasses.fake_tensor import FakeTensorMode

    for C, G in ((32, 32), (64, 32)):
        xc, wc, bc, sc, hc = _inputs(2, C, (3, 3), torch.bfloat16, seed=5)
        for xl in (xc.contiguous(memory_format=torch.channels_last), xc.transpose(2, 3)):
            args = (wc, bc, sc, hc, G, 1e-5, True)
            got = op(xl, *args)
            want = ops.norm_act_plain(xl, wc, bc, G, 1e-5, sc, hc, True)
            assert torch.equal(got, want) and got.stride() == want.stride()
            with FakeTensorMode() as mode:
                fake = op(mode.from_tensor(xl), *(mode.from_tensor(a) for a in args[:4]),
                          *args[4:])
            assert fake.stride() == got.stride()
    assert op(x.contiguous(memory_format=torch.channels_last), w, b, scale, shift, 32, 1e-5,
              True).stride() != x.stride()   # one channel a group: x's channels-last layout


class _Norm(torch.nn.Module):
    def __init__(self, use_kernels):
        super().__init__()
        self.norm = GroupNorm32(32)
        self.norm.use_kernels = use_kernels

    def forward(self, x, emb):
        return self.norm(x, tuple(torch.chunk(emb, 2, dim=-1)), silu_after=True)


def _traced_nodes(use_kernels, dtype):
    """Export one norm; return its op nodes, having held the program to the module."""
    x, _, _, scale, shift = _inputs(2, 32, (4, 4), dtype, seed=6)
    emb = torch.cat([scale, shift], dim=-1)
    module = _Norm(use_kernels).requires_grad_(False)
    with torch.no_grad():
        ep = torch.export.export(module, (x, emb))
    op = torch.ops.causaldiffae.norm_act_fwd.default
    with torch.no_grad():
        assert torch.equal(ep.module()(x, emb), module(x, emb))
    return [n for n in ep.graph.nodes if n.target is op]


@pytest.mark.parametrize("use_kernels", [True, False])
def test_traced_norm_is_one_op_node_on_the_kernel_route(use_kernels):
    assert len(_traced_nodes(use_kernels, torch.bfloat16)) == (1 if use_kernels else 0)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_traced_fp32_norm_follows_the_same_rule(use_kernels):
    """An fp32 model's norms take the kernel route too (the fp32 kernel)."""
    assert len(_traced_nodes(use_kernels, torch.float32)) == (1 if use_kernels else 0)


def test_traced_norm_that_needs_a_gradient_raises():
    """The backward kernel is reached from eager autograd only: a traced call
    with a gradient raises rather than run another route."""
    x, _, _, scale, shift = _inputs(2, 32, (4, 4), torch.float32, seed=9)
    module = _Norm(True)
    with pytest.raises(Exception, match="eager autograd only"):
        torch.export.export(module, (x.requires_grad_(True), torch.cat([scale, shift], -1)))


def test_prepare_builds_nothing_off_the_card(monkeypatch):
    """``ops.prepare`` builds no kernel for the CPU or where the model takes
    none; serving in bf16 readies the attention op through ``prepare_forward``."""
    from causaldiffae_torch import ops as pkg
    from causaldiffae_torch.ops import _build, attention

    built, readied = [], []
    monkeypatch.setattr(_build, "build", lambda name: built.append(name))
    monkeypatch.setattr(attention, "prepare_forward", lambda device: readied.append(device))
    pkg.prepare("cuda", False, True)
    pkg.prepare("cpu", True, False)
    pkg.prepare("cpu", True, True, training=True)
    assert built == [] and readied == []
    pkg.prepare("cpu", True, True)
    pkg.prepare("cuda:1", True, False)
    pkg.prepare("cuda:1", True, True, training=True)
    assert readied == ["cpu"]
    assert built == ["norm_act", "norm_act", "attention_fwd", "attention_bwd"]


def test_scale_shift_in_another_dtype_is_cast_first():
    """A scale-shift in fp32 beside bf16 x is cast to bf16, as the eager chain does."""
    x, w, b, scale, shift = _inputs(2, 32, (4, 4), torch.bfloat16, seed=7)
    want = _eager(x, w, b, 32, 1e-5, (scale.float(), shift.float()), True)
    got = ops.group_norm_act(x, w, b, 32, 1e-5, scale.float(), shift.float(), True)
    assert torch.equal(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, w, b, scale, shift = _inputs(2, 32, (4, 4), torch.bfloat16, seed=8)
    with pytest.raises(TypeError):
        ops._check(x.half(), w, b, 32, None, None)
    with pytest.raises(ValueError):
        ops._check(x.transpose(2, 3), w, b, 32, None, None)
    with pytest.raises(ValueError):
        ops._check(x, w, b, 32, scale, None)
    with pytest.raises(ValueError):
        ops._check(x, w.double(), b, 32, None, None)
    with pytest.raises(ValueError):
        ops._check(x, w, b, 32, scale.float(), shift.float())
    with pytest.raises(ValueError):
        ops._check(x[:, :30], w[:30], b[:30], 32, None, None)
    ops._check(x, w, b, 32, scale, shift)
