"""Differentiable rendering and inverse-rendering fits on torch autograd."""

from .fit import (
    FitResult, apply_params, finite_diff_check, fit, l1_loss, l2_loss,
    make_params, render_loss,
)

__all__ = ["FitResult", "apply_params", "finite_diff_check", "fit",
           "l1_loss", "l2_loss", "make_params", "render_loss"]
