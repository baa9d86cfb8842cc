"""Signal smoothing (counterpart of ``ionflux/ops/smoothing.py``): numpy
forms for the offline data-preparation path of the derivative surface, and
tensor forms (``smooth_same``, ``savitzky_golay``) for the on-device one.

``smooth_np``: reflect-padded window convolution; it returns length
n + window_len - 1, and ``smooth_same_np`` trims it back to n, as every
caller does.  ``savitzky_golay_np``: least-squares polynomial smoothing or
differentiation with the reference's signal-extension rule.  The tensor
forms are one 1-D convolution each (``torch.nn.functional.conv1d``, a cross-
correlation, so the taps go in flipped to compute ``np.convolve``); on the
card they need cuDNN's TF32 off.
"""

from __future__ import annotations

from math import factorial

import numpy as np
import torch

_WINDOWS = {
    "flat": lambda n: np.ones(n),
    "hanning": np.hanning,
    "hamming": np.hamming,
    "bartlett": np.bartlett,
    "blackman": np.blackman,
}


def smooth_np(x: np.ndarray, window_len: int = 11,
              window: str = "hanning") -> np.ndarray:
    """Reflect-pad by window_len - 1 on each side, convolve the normalised
    window, 'valid' mode: length n + window_len - 1."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim != 1:
        raise ValueError("smooth only accepts 1-d arrays")
    if len(x) < window_len:
        raise ValueError("input must be longer than the window")
    if window_len < 3:
        return x
    if window not in _WINDOWS:
        raise ValueError(f"unknown window {window!r}")
    s = np.r_[x[window_len - 1:0:-1], x, x[-2:-window_len - 1:-1]]
    w = _WINDOWS[window](window_len)
    return np.convolve(w / w.sum(), s, mode="valid")


def smooth_same_np(x: np.ndarray, window_len: int = 11,
                   window: str = "hanning") -> np.ndarray:
    """smooth_np(x)[w//2 : -(w//2)]: the same length as x."""
    h = window_len // 2
    out = smooth_np(x, window_len, window)
    return out[h:-h] if h else out


def _convolve_valid(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """``np.convolve(x, taps, mode="valid")`` for 1-D tensors."""
    if x.is_cuda and torch.backends.cudnn.allow_tf32:
        raise RuntimeError("smoothing is float32; set "
                           "torch.backends.cudnn.allow_tf32 = False")
    return torch.nn.functional.conv1d(
        x[None, None], taps.flip(0)[None, None])[0, 0]


def smooth_same(x: torch.Tensor, window_len: int = 11,
                window: str = "hanning") -> torch.Tensor:
    """Same-length smoothing of a tensor; matches smooth_same_np.
    Reflect-pads (without repeating the edge sample), then convolves."""
    w = torch.as_tensor(_WINDOWS[window](window_len), dtype=x.dtype,
                        device=x.device)
    w = w / torch.sum(w)
    h = window_len // 2
    if h == 0:
        return x
    left = x[1:h + 1].flip(0)
    right = x[-h - 1:-1].flip(0)
    return _convolve_valid(torch.cat([left, x, right]), w)


def savgol_coeffs(window_size: int, order: int, deriv: int = 0,
                  rate: float = 1.0) -> np.ndarray:
    """Savitzky-Golay filter taps."""
    if window_size % 2 != 1 or window_size < 1:
        raise ValueError("window_size must be a positive odd number")
    if window_size < order + 2:
        raise ValueError("window_size too small for the polynomial order")
    half = (window_size - 1) // 2
    b = np.array([[k ** i for i in range(order + 1)]
                  for k in range(-half, half + 1)], dtype=np.float64)
    return np.linalg.pinv(b)[deriv] * rate ** deriv * factorial(deriv)


def savitzky_golay_np(y: np.ndarray, window_size: int, order: int,
                      deriv: int = 0, rate: float = 1.0) -> np.ndarray:
    """Savitzky-Golay filtering, the signal extended by its mirrored
    differences at both ends."""
    y = np.asarray(y, dtype=np.float64)
    m = savgol_coeffs(window_size, order, deriv, rate)
    half = (window_size - 1) // 2
    first = y[0] - np.abs(y[1:half + 1][::-1] - y[0])
    last = y[-1] + np.abs(y[-half - 1:-1][::-1] - y[-1])
    ypad = np.concatenate((first, y, last))
    return np.convolve(m[::-1], ypad, mode="valid")


def savitzky_golay(y: torch.Tensor, window_size: int, order: int,
                   deriv: int = 0, rate: float = 1.0) -> torch.Tensor:
    """Savitzky-Golay on a tensor (the extension rule of
    savitzky_golay_np)."""
    m = torch.as_tensor(savgol_coeffs(window_size, order, deriv, rate),
                        dtype=y.dtype, device=y.device)
    half = (window_size - 1) // 2
    first = y[0] - torch.abs(y[1:half + 1].flip(0) - y[0])
    last = y[-1] + torch.abs(y[-half - 1:-1].flip(0) - y[-1])
    return _convolve_valid(torch.cat([first, y, last]), m.flip(0))
