"""What the norm kernels (``causaldiffae_torch/ops/norm_act.py``) are held to
on a card, shared by ``test_torch_cuda.py`` and ``chip_smoke.py``.

- :func:`chain_from_stats`: the eager chain's elementwise part on given
  statistics, each op one torch kernel, rounded where the chain rounds: on
  the forward kernel's statistics it gives the kernel's output bit for bit;
- :func:`bwd_magnitudes`: the backward formula of ``norm_act_bwd_plain``
  on the absolute values of its terms, the scale of what two summation
  orders of the same formula may differ by;
- :func:`bwd_errors`: each gradient's worst excess over one ulp of its
  dtype (bf16 outputs) plus 1e-4 of its terms' magnitude.
"""

import torch


def ulp(v: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of each value of v, in v's dtype (fp32)."""
    bits = 8 if v.dtype == torch.bfloat16 else 24
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32),
                       torch.frexp(v.float()).exponent - bits)


def chain_from_stats(x, mean, rstd, w, b, scale, shift, silu):
    """The eager chain's elementwise part on the statistics (mean, rstd) [B, G]."""
    B, C = x.shape[:2]
    G = mean.shape[1]
    y = ((x.float().reshape(B, G, -1) - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    bshape = (1, C) + (1,) * (x.ndim - 2)
    y = (y * w.reshape(bshape) + b.reshape(bshape)).to(x.dtype)
    if scale is not None:
        cshape = (B, C) + (1,) * (x.ndim - 2)
        y = y * (1 + scale.reshape(cshape)) + shift.reshape(cshape)
    return y * torch.sigmoid(y) if silu else y


def bwd_magnitudes(x, dy, w, b, scale, shift, silu, mean, rstd):
    """``(dx, d_weight, d_bias, d_scale, d_shift)`` of the plain backward
    formula with every term and factor taken by its absolute value, fp32;
    dx as ``rstd (|g1 w| + |mean(g1 w)| + |x-hat| |mean(g1 w x-hat)|)``."""
    dt = x.dtype
    B, C = x.shape[:2]
    G = mean.shape[1]
    xh = ((x.float().reshape(B, G, -1) - mean[..., None]) * rstd[..., None]).reshape(B, C, -1)
    y1 = (xh * w[:, None] + b[:, None]).to(dt)
    z = y1
    if scale is not None:
        sp = 1 + scale.to(dt)[:, :, None]
        z = y1 * sp + shift.to(dt)[:, :, None]
    g = dy.float().reshape(B, C, -1)
    if silu:
        s = torch.sigmoid(z.float())
        g = g * (s * (1 + z.float() * (1 - s)))
    g = g.abs()
    d_scale = d_shift = None
    if scale is not None:
        d_shift = g.sum(-1)
        d_scale = (g * y1.float().abs()).sum(-1)
        g = g * sp.float().abs()
    xh = xh.abs()
    d_bias = g.sum((0, 2))
    d_weight = (g * xh).sum((0, 2))
    gw = (g * w.abs()[:, None]).reshape(B, G, -1)
    xg = xh.reshape(B, G, -1)
    dx = rstd[..., None] * (gw + gw.mean(-1, keepdim=True)
                            + xg * (gw * xg).mean(-1, keepdim=True))
    return dx.reshape(x.shape), d_weight, d_bias, d_scale, d_shift


def bwd_errors(got, plain, mags):
    """For each of the five gradients, the largest of ``|kernel - plain| -
    (ulp(plain) + 1e-4 magnitude)`` (at most 0 where it holds; None where
    the gradient is absent), raising where one is present on one side only
    or differs in dtype or shape."""
    out = []
    for k, p, m in zip(got, plain, mags):
        if p is None or k is None:
            if (p is None) != (k is None):
                raise AssertionError("a gradient present on one side only")
            out.append(None)
            continue
        if k.dtype != p.dtype or k.shape != p.shape:
            raise AssertionError(f"{k.dtype} {tuple(k.shape)} against {p.dtype} {tuple(p.shape)}")
        limit = (ulp(p) if p.dtype == torch.bfloat16 else 0) + 1e-4 * m.reshape(p.shape)
        out.append(float(((k.float() - p.float()).abs() - limit).max()))
    return out
