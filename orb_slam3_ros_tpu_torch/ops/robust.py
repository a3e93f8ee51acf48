"""Robust-loss reweighting (IRLS) — port of ``orb_slam3_ros_tpu.ops.robust``."""

from __future__ import annotations

import torch

# Chi-square 95% quantiles (the reference's Optimizer.cc:1213 and :1260).
CHI2_MONO = 5.991  # 2 DoF
CHI2_STEREO = 7.815  # 3 DoF


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of the Huber loss for squared error ``chi2``:
    min(1, delta / sqrt(chi2))."""
    s = torch.clamp(chi2, min=1e-12)
    return torch.clamp(torch.sqrt(delta2 / s), max=1.0)


def cauchy_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of the Cauchy loss: 1 / (1 + chi2 / delta2)."""
    return 1.0 / (1.0 + chi2 / delta2)


def tukey_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of Tukey's biweight: (1 - chi2 / delta2)^2 inside the
    threshold, 0 beyond it."""
    r = chi2 / delta2
    return torch.where(r < 1.0, (1.0 - r) ** 2, torch.zeros_like(r))
