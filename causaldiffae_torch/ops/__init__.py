"""Hand-written CUDA kernels for Hopper and their wrappers."""


def prepare(device, use_kernels: bool, bf16: bool, training: bool = False) -> None:
    """Ready, before the first call, the kernels that a model of this
    configuration launches on ``device``: with ``use_kernels`` the norm pair
    (``norm_act.py``), and with bf16 too the attention forward and, when
    ``training``, its backward. Serving's go through
    ``attention.prepare_forward``, which also readies the attention op."""
    if not use_kernels:
        return
    from . import _build, attention

    if bf16 and not training:
        attention.prepare_forward(device)
    elif str(device).startswith("cuda"):
        _build.build("norm_act")
        if bf16:
            _build.build("attention_fwd")
            _build.build("attention_bwd")
