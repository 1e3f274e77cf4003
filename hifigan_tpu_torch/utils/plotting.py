"""TensorBoard figure builders (port of ``hifigan_tpu/utils/plotting.py``).

matplotlib is imported inside the drawing functions only: the module
imports without it (the card's machine has none), the figures are reached
only through a TensorBoard writer, and the callbacks ask :func:`available`
before they draw.

Covers the visualisation surface of reference ``src/utils.py:16-63``
(spectrogram / image / categorical / matrix figures) with one shared
heatmap core instead of four near-identical functions. All figures are
rendered on the Agg backend (training runs headless) and returned closed —
``SummaryWriter.add_figure`` only needs the drawn canvas.
"""

from __future__ import annotations

import colorsys
import functools
import importlib.util

# Deterministic categorical palette: golden-angle hue walk across three
# lightness bands. Neighbouring class indices land far apart on the hue
# wheel, so adjacent label ids in a plot stay visually distinct.
_GOLDEN_ANGLE = 0.618033988749895
_N_CATEGORY_COLORS = 300


def _category_color(i: int) -> tuple[float, float, float]:
    hue = (i * _GOLDEN_ANGLE) % 1.0
    band = i % 3
    value = (0.95, 0.70, 0.45)[band]
    saturation = (0.85, 0.95, 0.75)[band]
    return colorsys.hsv_to_rgb(hue, saturation, value)


CATEGORY_PALETTE = [_category_color(i) for i in range(_N_CATEGORY_COLORS)]


@functools.lru_cache(maxsize=None)
def available() -> bool:
    """Whether matplotlib imports here (printing a note once where it does not)."""
    if importlib.util.find_spec("matplotlib") is None:
        print("no matplotlib: TensorBoard figures are left out")
        return False
    return True


def _heatmap(data, *, size=None, origin="upper", cmap=None, norm=None):
    """Render a 2-D array as an imshow figure with a colorbar (closed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=size)
    ax = fig.add_subplot()
    mappable = ax.imshow(
        data,
        aspect="auto",
        origin=origin,
        interpolation="none",
        cmap=cmap,
        norm=norm,
    )
    fig.colorbar(mappable, ax=ax)
    fig.canvas.draw()
    plt.close(fig)
    return fig


def plot_spectrogram(spectrogram):
    """Mel/linear spectrogram: time on x, frequency bin 0 at the bottom."""
    return _heatmap(spectrogram, size=(10, 4), origin="lower")


def plot_image(image):
    """Generic 2-D array (snake weight images etc.), default colormap."""
    return _heatmap(image)


def plot_categorical(categorical):
    """Integer class-id matrix with one fixed color per class id."""
    from matplotlib.colors import BoundaryNorm, ListedColormap

    cmap = ListedColormap(CATEGORY_PALETTE)
    # map id k to palette entry k exactly: bin edges at the half-integers
    edges = [k - 0.5 for k in range(len(CATEGORY_PALETTE) + 1)]
    return _heatmap(
        categorical,
        size=(10, 4),
        origin="lower",
        cmap=cmap,
        norm=BoundaryNorm(edges, cmap.N),
    )


def plot_matrix(matrix):
    """Confusion-style matrix, larger canvas."""
    return _heatmap(matrix, size=(10, 7))
