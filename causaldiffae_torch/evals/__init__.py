"""Counterfactual, reconstruction and prior generation (serving subset)."""

from .counterfactual import (
    make_counterfactual_fn,
    make_prior_sample_fn,
    make_reconstruct_fn,
    resolve_sampler,
)

__all__ = ["make_counterfactual_fn", "make_prior_sample_fn", "make_reconstruct_fn",
           "resolve_sampler"]
