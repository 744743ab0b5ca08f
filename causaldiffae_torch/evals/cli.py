"""Start-up shared by the port's evaluation CLIs (``counterfactual_test``,
``classifier_train``, ``rescore_counterfactuals``, ``nll``, ``sample``).

``counterfactual_test``, ``nll`` and ``sample`` run across the ranks that
``torchrun`` starts (or a process group the caller set up), as the JAX CLIs
run across hosts: each rank draws its own share, the ranks gather the
samples, and the primary writes. ``classifier_train`` and
``rescore_counterfactuals`` stay single-process, as the JAX package's do.
"""

from __future__ import annotations

import torch

from ..config import get_config
from ..ops import prepare
from ..parallel import init_from_env
from ..utils import determinism, logger

__all__ = ["start", "restore_model"]


def start(device: str, *, across_ranks: bool = False) -> str:
    """Refuse a CUDA device where there is none (``--device cpu`` runs on the
    CPU); join ``torchrun``'s process group when the CLI runs ``across_ranks``,
    else refuse ``torch.distributed``; hold cuDNN to deterministic
    algorithms, so that the probes a rerun trains are the same bits; send
    log lines to stderr (the primary rank's), so that stdout holds only the
    CLI's JSON line. Returns this rank's device."""
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    if across_ranks:
        device = init_from_env(device)
    elif torch.distributed.is_available() and torch.distributed.is_initialized():
        raise SystemExit("this CLI is single-process, as the JAX package's; run it outside "
                         "torch.distributed")
    determinism.pin()
    logger.configure(format_strs=["stderr"])
    return device


def restore_model(preset, ckpt_dir, use_ema: bool, seed: int, device: str):
    """(config, model, step) in eval mode on ``device``: the latest checkpoint
    in ``ckpt_dir`` with the config it was trained with (``preset``, when
    given, must match it), else ``preset`` (default morphomnist_causaldae)
    with weights made from ``seed`` and step None. The configuration's
    kernels are made ready here (``ops.prepare``), before the first UNet call."""
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
    prepare(device, cfg.use_kernels, cfg.use_bf16)
    return cfg, model, step
