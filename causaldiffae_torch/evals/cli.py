"""Start-up shared by the port's evaluation CLIs (``counterfactual_test``,
``classifier_train``, ``rescore_counterfactuals``, ``nll``, ``sample``)."""

from __future__ import annotations

import torch

from ..config import get_config
from ..ops import _build
from ..utils import determinism, logger

__all__ = ["start", "restore_model"]


def start(device: str) -> None:
    """Refuse a CUDA device where there is none (``--device cpu`` runs on the
    CPU) and ``torch.distributed`` (the CLIs are single-process; cross-process
    gathers come with data parallelism); hold cuDNN to deterministic
    algorithms, so that the probes a rerun trains are the same bits; send
    log lines to stderr, so that stdout holds only the CLI's JSON line."""
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        raise SystemExit("the evaluation CLIs are single-process; run them outside "
                         "torch.distributed")
    determinism.pin()
    logger.configure(format_strs=["stderr"])


def restore_model(preset, ckpt_dir, use_ema: bool, seed: int, device: str):
    """(config, model, step) in eval mode on ``device``: the latest checkpoint
    in ``ckpt_dir`` with the config it was trained with (``preset``, when
    given, must match it), else ``preset`` (default morphomnist_causaldae)
    with weights made from ``seed`` and step None. On the card the attention
    kernel is built here, before the first UNet call."""
    from ..serve import build_model, load_checkpoint

    if ckpt_dir:
        cfg, model, step = load_checkpoint(ckpt_dir, use_ema, device)
        if preset not in (None, cfg.name):
            raise SystemExit(f"--preset {preset}: the checkpoint in {ckpt_dir} was trained "
                             f"as {cfg.name}")
        logger.log(f"restored step {step} from {ckpt_dir} "
                   f"({'EMA' if use_ema else 'raw'} weights)")
    else:
        cfg, step = get_config(preset or "morphomnist_causaldae"), None
        model = build_model(cfg, "", seed, device)
    if device.startswith("cuda") and cfg.use_kernels and cfg.use_bf16:
        _build.build("attention_fwd")
    return cfg, model, step
