"""Gait analysis and plotting (host-side, eval only).

Counterpart of ``puppax/tools/plotting.py``: named time series on one
time axis (``plot_multi_series``: plotly first, then matplotlib, both
imported when used) and the Hilbert transform (amplitude envelope,
instantaneous frequency and phase) used to read a gait's periodicity,
computed with ``torch.fft`` in float64 on the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _unwrap(phase: torch.Tensor) -> torch.Tensor:
    """``np.unwrap(phase, axis=0)``: add multiples of 2 pi where a step
    along the time axis jumps by more than pi."""
    d = torch.diff(phase, dim=0)
    dmod = torch.remainder(d + math.pi, 2.0 * math.pi) - math.pi
    dmod = torch.where((dmod == -math.pi) & (d > 0), torch.full_like(dmod, math.pi), dmod)
    correct = torch.where(d.abs() < math.pi, torch.zeros_like(d), dmod - d)
    out = phase.clone()
    out[1:] += torch.cumsum(correct, dim=0)
    return out


def hilbert_transform(data, dt: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Amplitude envelope, instantaneous frequency (Hz) and phase of a real
    signal through its analytic signal.

    ``data`` is a numpy array or a tensor of shape (T,) or (T, C); the
    results are numpy arrays of that shape, the frequency T-1 long on the
    time axis."""
    if isinstance(data, torch.Tensor):
        x = data.detach().to("cpu", torch.float64)
    else:
        x = torch.from_numpy(np.asarray(data, np.float64))
    n = x.shape[0]
    spectrum = torch.fft.fft(x, dim=0)
    h = torch.zeros(n, dtype=torch.float64)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1 : n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1 : (n + 1) // 2] = 2.0
    h = h.reshape((n,) + (1,) * (x.dim() - 1))
    analytic = torch.fft.ifft(spectrum * h, dim=0)

    amplitude_envelope = analytic.abs()
    instantaneous_phase = _unwrap(torch.angle(analytic))
    instantaneous_frequency = torch.diff(instantaneous_phase, dim=0) / (2.0 * math.pi * dt)
    return (amplitude_envelope.numpy(), instantaneous_frequency.numpy(),
            instantaneous_phase.numpy())


def _columns(series: Dict[str, np.ndarray]):
    """(label, values) per line: a (T,) series as it is, a (T, C) series
    as its C columns ``name[c]``."""
    for name, values in series.items():
        values = np.asarray(values)
        if values.ndim == 1:
            yield name, values
        else:
            for c in range(values.shape[1]):
                yield f"{name}[{c}]", values[:, c]


def plot_multi_series(series: Dict[str, np.ndarray], dt: float, title: str = "",
                      ylabel: str = "", backend: Optional[str] = None):
    """Plot named time series on one time axis.

    backend: 'plotly' | 'matplotlib' | None (the first that imports:
    plotly, then matplotlib). Returns the figure, or None if no plotting
    backend exists; a forced 'plotly' raises ImportError without plotly."""
    first = next(iter(series.values()))
    t = np.arange(np.asarray(first).shape[0]) * dt

    if backend in (None, "plotly"):
        try:
            import plotly.graph_objects as go

            fig = go.Figure()
            for label, values in _columns(series):
                fig.add_trace(go.Scatter(x=t, y=values, name=label))
            fig.update_layout(title=title, xaxis_title="time [s]", yaxis_title=ylabel)
            return fig
        except ImportError:
            if backend == "plotly":
                raise

    try:
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        for label, values in _columns(series):
            ax.plot(t, values, label=label)
        ax.set_title(title)
        ax.set_xlabel("time [s]")
        ax.set_ylabel(ylabel)
        ax.legend()
        return fig
    except ImportError:
        return None
