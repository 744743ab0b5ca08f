"""Counterfactual, reconstruction and prior generation; probes, metrics and FID."""

from .classifiers import ClassifierTrainer, classifier_predict_fn, load_classifier
from .counterfactual import (
    make_counterfactual_fn,
    make_prior_sample_fn,
    make_reconstruct_fn,
    resolve_sampler,
)
from .metrics import compute_dci, compute_irs, mcc

__all__ = ["ClassifierTrainer", "classifier_predict_fn", "load_classifier",
           "make_counterfactual_fn", "make_prior_sample_fn", "make_reconstruct_fn",
           "resolve_sampler", "compute_dci", "compute_irs", "mcc"]
