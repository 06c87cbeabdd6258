"""Kalman smoothing of per-task probability vectors (camera/stream mode).

The reference smooths each task's softmax vector with
``pykalman.KalmanFilter(initial_state_mean=0, initial_state_covariance=I,
n_dim_obs=M).filter_update``.  With pykalman's defaults that is the
identity-dynamics filter:

    predict:  x- = x,          P- = P + Q          (Q = I)
    update:   K  = P- (P- + R)^-1                   (R = I)
              x  = x- + K (z - x-),  P = (I - K) P-

The state is stacked and padded to [T, Kmax] so all tasks update in a few
elementwise ops per frame, on the device of the caller's tensors.  The
identity-matrix defaults keep the covariance diagonal forever, so the
diagonal form is exact, not an approximation.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class KalmanState(NamedTuple):
    mean: torch.Tensor  # [T, K] state means
    cov: torch.Tensor  # [T, K] diagonal covariances


def init_state(num_tasks: int, max_classes: int, device="cpu") -> KalmanState:
    """Matches pykalman init: zero mean, identity covariance."""
    return KalmanState(
        mean=torch.zeros((num_tasks, max_classes), dtype=torch.float32, device=device),
        cov=torch.ones((num_tasks, max_classes), dtype=torch.float32, device=device),
    )


def filter_update(
    state: KalmanState, obs: torch.Tensor, q: float = 1.0, r: float = 1.0
) -> Tuple[KalmanState, torch.Tensor]:
    """One identity-dynamics Kalman update.  obs: [T, K] (padded probs).

    Returns (new_state, smoothed_obs).  q/r are the (scalar, diagonal)
    transition/observation covariances; pykalman defaults are 1.0.
    """
    pred_cov = state.cov + q
    gain = pred_cov / (pred_cov + r)
    mean = state.mean + gain * (obs - state.mean)
    cov = (1.0 - gain) * pred_cov
    return KalmanState(mean=mean, cov=cov), mean
