"""The arithmetic of the numbers compared: per-bin errors merged over
blocks and ranks, and the largest error of a bin over that bin's scale."""

import torch


def merge(pairs):
    """Elementwise maxima of a list of (error, scale) tensors."""
    err = torch.stack([e for e, _ in pairs]).amax(dim=0)
    scale = torch.stack([s for _, s in pairs]).amax(dim=0)
    return err, scale


def worst_ratio(err, scale) -> float:
    """max over bins of err / scale: inf where a bin of scale 0 has an
    error, NaN where any error is NaN."""
    if bool(torch.isnan(err).any()) or bool(torch.isnan(scale).any()):
        return float("nan")
    ratio = torch.where(scale > 0, err / scale.clamp_min(1e-300),
                        torch.where(err == 0, 0.0, float("inf")))
    return float(ratio.max())
