"""Prediction (port of ``hmsc_tpu/predict``): posterior-predictive draws
at new covariates and units through the serving kernel B9a, latent-factor
kriging at new units (Full / NNGP / GPP), and gradient construction.
Cross-validation (``cv.py``) and offline conditional prediction are
ROADMAP A8b.

Reference surface: ``R/predict.R``, ``R/predictLatentFactor.R``,
``R/constructGradient.R``, ``R/prepareGradient.R``.
"""

from .latent import predict_latent_factor
from .predict import predict
from .gradient import construct_gradient, prepare_gradient

__all__ = ["predict", "predict_latent_factor", "construct_gradient",
           "prepare_gradient"]
