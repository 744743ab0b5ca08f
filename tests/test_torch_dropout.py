"""The ResBlock's dropout in the port against flax's ``nn.Dropout``.

- A train-mode ResBlock with ``dropout=0.1`` (both branches: scale-shift and
  additive) against the JAX package's on the same weights, input and
  embedding, in fp32 and in bf16, with flax's keep masks replayed: they are
  recorded by intercepting the block's ``nn.Dropout`` calls
  (``flax.linen.intercept_methods``; an element is kept where flax's output
  is non-zero, and where the input itself is 0 either choice gives 0), and
  handed to the port through its ``drop`` callable. fp32: atol 2e-4, rtol
  1e-3. bf16: every output within 4 bf16 ulps of the largest one, atol
  2^-6 * max|out|, and RMS(diff) <= 2^-6 * RMS(out) (the two sides round the
  convs' inputs and the residual sum in bf16 at different points; measured
  0.75% RMS, where a wrong mask moves a tenth of the entries by O(1)); the
  dropout alone is bit-equal to flax's in both dtypes (kept entries divided
  by the keep probability in h's dtype).
- Eval mode: dropout is the identity (the block equals the same block
  built with rate 0, and flax's with ``train=False``).
- Training on the CPU with dropout on: 2 steps, a checkpoint, and 2 more in
  a fresh loop from another init and another global RNG state end
  bit-equal to 4 straight steps, since the masks come from the step's
  (seed, step) generator; and they differ from a run without dropout.
"""

import numpy as np
import pytest
import torch

from _port_fixtures import one_torch_thread, tiny_kwargs  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RATE = 0.1
B, C_IN, C_OUT, HW, EMB = 3, 32, 64, 8, 48


def _blocks(scale_shift, bf16, rate=RATE):
    import jax
    import jax.numpy as jnp

    from causaldiffae_tpu.models.layers import ResBlock as JaxResBlock
    from causaldiffae_torch.models.layers import ResBlock
    from causaldiffae_torch.utils.weights import _resblock

    dtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jblock = JaxResBlock(C_IN, EMB, dropout=rate, out_channels=C_OUT,
                         use_scale_shift_norm=scale_shift, dtype=dtype[0])
    x = jnp.zeros((1, HW, HW, C_IN))
    params = jblock.init(jax.random.PRNGKey(0), x, jnp.zeros((1, EMB)))["params"]
    rng = np.random.RandomState(7)
    params = jax.tree_util.tree_map(lambda a: (0.05 * rng.randn(*a.shape)).astype(np.float32),
                                    params)
    for gn in ("GroupNorm32_0", "GroupNorm32_1"):
        params[gn]["scale"] = (1.0 + 0.05 * rng.randn(*params[gn]["scale"].shape)
                               ).astype(np.float32)
    sd = {}
    _resblock(sd, "b", params)
    block = ResBlock(C_IN, EMB, C_OUT, scale_shift, dtype[1], rate)
    block.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    return jblock, params, block


def _inputs():
    rng = np.random.RandomState(3)
    return (rng.randn(B, HW, HW, C_IN).astype(np.float32),
            rng.randn(B, EMB).astype(np.float32))


def _flax_train(jblock, params, x, emb):
    """flax's train-mode output and the keep masks its Dropout drew (NHWC)."""
    import flax.linen as nn
    import jax

    masks = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            masks.append(np.asarray(out) != 0)
        return out

    with nn.intercept_methods(record):
        out = jblock.apply({"params": params}, x, emb, train=True,
                           rngs={"dropout": jax.random.PRNGKey(11)})
    return np.asarray(out, np.float32), masks


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("scale_shift", [True, False], ids=["scale_shift", "additive"])
def test_train_mode_resblock_matches_flax_with_replayed_masks(scale_shift, bf16):
    import jax.numpy as jnp

    jblock, params, block = _blocks(scale_shift, bf16)
    x, emb = _inputs()
    want, masks = _flax_train(jblock, params, jnp.asarray(x), jnp.asarray(emb))
    assert len(masks) == 1 and masks[0].shape == (B, HW, HW, C_OUT)
    assert 0.8 < masks[0].mean() < 0.97  # about 1 - RATE kept
    block.train()
    calls = []

    def drop(shape):
        calls.append(tuple(shape))
        return torch.from_numpy(masks[0].transpose(0, 3, 1, 2).copy())

    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    got = block(xt.to(block.dtype), torch.from_numpy(emb), drop).float()
    got = got.detach().numpy().transpose(0, 2, 3, 1)
    assert calls == [(B, C_OUT, HW, HW)]
    if bf16:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * float(np.abs(want).max()))
        rms = lambda a: float(np.sqrt(np.mean(a ** 2)))  # noqa: E731
        assert rms(got - want) <= 2.0 ** -6 * rms(want)
    else:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    # the mask reached the output: dropped entries differ from the mask-free block
    block.eval()
    kept = block(xt.to(block.dtype), torch.from_numpy(emb)).float().detach().numpy()
    assert not np.allclose(kept.transpose(0, 2, 3, 1), got, atol=1e-3)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_dropout_alone_is_bit_equal_to_flax(bf16):
    """Kept entries divided by the keep probability in h's dtype: bf16's
    0.8984375, not fp32's 0.9 (flax's ``inputs / keep_prob`` on a bf16 h)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from causaldiffae_torch.models.layers import ResBlock

    h = np.random.RandomState(5).randn(2, 32, 4, 4).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    want = nn.Dropout(RATE, deterministic=False).apply(
        {}, jnp.asarray(h, jdt), rngs={"dropout": jax.random.PRNGKey(2)})
    want = np.asarray(want.astype(jnp.float32))
    block = ResBlock(32, 16, dropout=RATE).train()
    got = block.dropout(torch.from_numpy(h).to(tdt), lambda shape: torch.from_numpy(want != 0))
    assert got.dtype == tdt
    assert got.float().numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("scale_shift", [True, False], ids=["scale_shift", "additive"])
def test_eval_mode_dropout_is_the_identity(scale_shift):
    import jax.numpy as jnp

    jblock, params, block = _blocks(scale_shift, False)
    _, _, plain = _blocks(scale_shift, False, rate=0.0)
    plain.load_state_dict(block.state_dict())
    x, emb = _inputs()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    block.eval()
    out = block(xt, torch.from_numpy(emb), lambda shape: torch.zeros(shape))  # never drawn
    assert torch.equal(out, plain.eval()(xt, torch.from_numpy(emb)))
    want = jblock.apply({"params": params}, jnp.asarray(x), jnp.asarray(emb), train=False)
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               atol=2e-4, rtol=1e-3)


def _cfg(**kw):
    from causaldiffae_torch.config import Config

    return Config(**tiny_kwargs(use_bf16=False, use_kernels=False, dropout=RATE, batch_size=2,
                                log_interval=2, save_interval=2, lr=1e-3, **kw))


def _model(cfg, seed):
    from causaldiffae_torch.config import create_model

    torch.manual_seed(seed)
    return create_model(cfg, device="cpu")


def test_resume_with_dropout_is_bit_equal_to_a_straight_run(tmp_path):
    from causaldiffae_torch.config import create_diffusion
    from causaldiffae_torch.training import CheckpointManager, run_training

    rng = np.random.RandomState(0)
    data = [{"image": (rng.randint(0, 256, (2, 28, 28, 1)) / 255).astype(np.float32),
             "y": rng.randint(0, 10, (2,)).astype(np.int64),
             "c": rng.randn(2, 2).astype(np.float32)} for _ in range(6)]
    cfg = _cfg()
    straight, _ = run_training(cfg, _model(cfg, 0), create_diffusion(cfg), iter(data),
                               total_steps=4, log_interval=2, device="cpu")
    ck = str(tmp_path / "ck")
    run_training(cfg, _model(cfg, 0), create_diffusion(cfg), iter(data), total_steps=2,
                 log_interval=2, device="cpu", ckpt_dir=ck)
    assert CheckpointManager(ck).all_steps() == [2]
    resumed, _ = run_training(cfg, _model(cfg, 9), create_diffusion(cfg), iter(data[2:]),
                              total_steps=4, log_interval=2, device="cpu", ckpt_dir=ck)
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for r in straight.ema:
        for k, v in straight.ema[r].items():
            assert torch.equal(v, resumed.ema[r][k]), k
    cfg0 = cfg.replace(dropout=0.0)
    plain, _ = run_training(cfg0, _model(cfg0, 0), create_diffusion(cfg0), iter(data),
                            total_steps=4, log_interval=2, device="cpu")
    assert not torch.equal(plain.model.out[2].weight, straight.model.out[2].weight)
