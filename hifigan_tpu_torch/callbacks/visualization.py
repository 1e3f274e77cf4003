"""Validation observability callbacks (port of
``hifigan_tpu/callbacks/visualization.py``).

Parity with reference confusion_logging_callback.py /
validation_classification_callback.py / validation_visualization_callback.py
/ gan_models_graph_visualization_callback.py:

- per-label confusion matrices with per-class recall scalars + figures,
- validation audio (add_audio) / mel (plot_spectrogram) / categorical label
  plots, parameter histograms,
- a one-shot model "graph" dump (a parameter summary text per model).

Figures need matplotlib: where it does not import (the card's machine has
TensorBoard but no matplotlib), the figures are left out, with one note,
and every scalar, histogram, audio clip and text is logged as before. (The
JAX callbacks raise there.)

The callbacks read host arrays (the trainer moves a validation batch's
data to the host before firing). Parameters are logged under the JAX
package's key paths: a port train state's modules are read through
``train/checkpoint.py::dsl_variables_to_jax`` (:func:`state_variables`), so
tags, histograms and images are the JAX trainer's for the same weights.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from hifigan_tpu_torch.callbacks.base import Callback, TrainLoop
from hifigan_tpu_torch.callbacks.logging import rank
from hifigan_tpu_torch.utils import plotting
from hifigan_tpu_torch.utils.plotting import plot_categorical, plot_matrix, plot_spectrogram


def add_figure(writer, tag: str, draw, data, step: int) -> None:
    """``writer.add_figure(tag, draw(data), step)`` where matplotlib imports."""
    if plotting.available():
        writer.add_figure(tag, draw(data), step)


def state_variables(state):
    """A port train state's variables in the JAX trainer's layout (numpy):
    ``{model: variables}`` of a ``DistillTrainState`` (keepers, hunters and
    sniffers as ``{key: variables}``), one module's variables of a
    ``SnifferTrainState``; None for anything else."""
    from hifigan_tpu_torch.train.checkpoint import (
        distill_state_dicts,
        distill_variables_to_jax,
        dsl_variables_to_jax,
    )

    if hasattr(state, "models"):
        return distill_variables_to_jax(distill_state_dicts(state.models))
    if hasattr(state, "sniffer"):
        return dsl_variables_to_jax(state.sniffer.state_dict())
    return None


def leaves_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, np.ndarray]]:
    """``(key path, leaf)`` in the JAX pytree order (dict keys sorted)."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in leaves_with_path(tree[k], prefix + (k,))]
    return [(prefix, tree)]


class ConfusionLoggingCallback:
    """Log a confusion matrix: figure + per-class recall scalars
    (reference confusion_logging_callback.py:10-59)."""

    def log_confusion(self, writer, prefix, matrix: np.ndarray, class_names, step) -> None:
        if writer is None:
            return
        with np.errstate(invalid="ignore", divide="ignore"):
            recalls = np.diag(matrix) / matrix.sum(axis=1)
        for name, recall in zip(class_names, recalls):
            if np.isfinite(recall):
                writer.add_scalar(rank(f"{prefix}/recall/{name}"), float(recall), step)
        norm = matrix / np.maximum(matrix.sum(axis=1, keepdims=True), 1)
        add_figure(writer, rank(f"{prefix}/confusion"), plot_matrix, norm, step)


class ValidationClassificationCallback(Callback, ConfusionLoggingCallback):
    """Accumulate confusion matrices over validation batches from the
    transform_data 'label' dict ({'truth','keep','sniff','hunt'} trees,
    reference validation_classification_callback.py) and flush at the end."""

    def __init__(self, label_options_groups: dict, interval: int = 1):
        self.label_options_groups = label_options_groups
        self.interval = interval
        self._matrices: dict = {}

    def _accumulate(self, kind: str, group: str, label: str, truth, pred) -> None:
        options = self.label_options_groups[group][label]
        n = len(options)
        key = (kind, group, label)
        mat = self._matrices.setdefault(key, np.zeros((n, n), np.int64))
        truth = np.asarray(truth).reshape(-1)
        pred = np.asarray(pred)
        if pred.ndim > truth.ndim:  # probabilities -> argmax class
            pred = pred.argmax(-1)
        pred = pred.reshape(-1)
        np.add.at(mat, (truth, pred), 1)

    def on_validation_batch_end(self, loop: TrainLoop, losses, data) -> None:
        if not isinstance(data, Mapping) or "label" not in data:
            return
        labels = data["label"]
        truth = labels.get("truth")
        if truth is None:
            return
        for kind in ("keep", "sniff", "hunt"):
            preds = labels.get(kind)
            if preds is None:
                continue
            for group, group_truth in truth.items():
                for label, label_truth in group_truth.items():
                    if group in preds and label in preds[group]:
                        self._accumulate(kind, group, label, label_truth, preds[group][label])

    def on_validation_end(self, loop: TrainLoop) -> None:
        for (kind, group, label), mat in self._matrices.items():
            self.log_confusion(
                loop.writer,
                f"validation_classification/{kind}/{group}/{label}",
                mat,
                self.label_options_groups[group][label],
                loop.global_step,
            )
        self._matrices = {}


class ValidationVisualizationCallback(Callback):
    """Audio/mel/label visualisations on validation
    (reference validation_visualization_callback.py:18-40,216-234)."""

    def __init__(self, sampling_rate: int, amount_to_log: int = 1):
        self.sampling_rate = sampling_rate
        self.amount_to_log = amount_to_log
        self._logged = 0

    def on_validation_batch_end(self, loop: TrainLoop, losses, data) -> None:
        if loop.writer is None or self._logged >= self.amount_to_log:
            return
        if not isinstance(data, Mapping):
            return
        step = loop.global_step
        i = self._logged
        wavs = data.get("wav", {})
        for name, wav in wavs.items():
            wav = np.asarray(wav)
            mono = wav[0].reshape(-1)
            loop.writer.add_audio(
                rank(f"validation_wavs/{i}/{name}"), mono[:, None], step, self.sampling_rate
            )
        mels = data.get("mel", {})
        for name, mel_val in mels.items():
            mel_val = np.asarray(mel_val)
            add_figure(
                loop.writer, rank(f"validation_mels/{i}/{name}"), plot_spectrogram, mel_val[0], step
            )
        labels = data.get("label", {})
        for name, group_tree in labels.items():
            rows = []
            for group, label_tree in sorted(group_tree.items()):
                for label, values in sorted(label_tree.items()):
                    values = np.asarray(values)
                    if values.ndim > 2:
                        values = values.argmax(-1)
                    rows.append(values[0].reshape(-1))
            if rows:
                width = max(len(r) for r in rows)
                mat = np.stack([np.pad(r, (0, width - len(r))) for r in rows])
                add_figure(
                    loop.writer, rank(f"validation_labels/{i}/{name}"), plot_categorical, mat, step
                )
        self._logged += 1

    def on_validation_end(self, loop: TrainLoop) -> None:
        self._logged = 0
        # parameter histograms + snake images
        # (ref validation_visualization_callback.py:42-150)
        variables = state_variables(loop.state) if loop.writer is not None else None
        if variables is not None:
            log_model_parameters(loop.writer, variables, loop.global_step)


def _model_param_trees(variables) -> dict:
    """{model_name: params tree}. Accepts either a {name: variables} dict
    (distill trainer) or a single flax variables dict (sniffer trainer)."""
    if isinstance(variables, Mapping) and "params" in variables:
        return {"model": variables["params"]}
    out = {}
    for name, vs in variables.items():
        if isinstance(vs, Mapping):
            out[name] = vs.get("params", vs)
    return out


def _conv_leaves(params) -> list[tuple[str, np.ndarray, np.ndarray | None]]:
    """Ordered (name, weight_2d, bias) per conv-like module: the weight is
    the 'kernel' or weight-norm 'v' leaf reduced over its spatial axes to
    (out, in) — the reference's torch.mean over dims >= 2
    (validation_visualization_callback.py:60)."""
    out = []

    def walk(node, prefix):
        if not isinstance(node, Mapping):
            return
        w = node.get("kernel", node.get("v"))
        if w is not None and getattr(w, "ndim", 0) >= 2:
            w = np.asarray(w)
            # our layouts put spatial dims first ((K, I, O) / (KH, KW, I, O));
            # reduce them and transpose to torch's (out, in) orientation
            w2 = w.mean(axis=tuple(range(w.ndim - 2))).T
            bias = node.get("bias")
            out.append((prefix, w2, np.asarray(bias) if bias is not None else None))
            return
        for k in sorted(node.keys(), key=str):
            child = node[k]
            if isinstance(child, Mapping):
                walk(child, f"{prefix}.{k}" if prefix else str(k))

    walk(params, "")
    return out


def parameter_snake_images(params) -> dict[str, np.ndarray]:
    """Chained weight-matrix 'snake' images: consecutive conv weights whose
    dimensions chain (prev out == next in) are laid out alternately
    horizontally/vertically, with bias strips at max value as separators —
    the reference's snake construction
    (validation_visualization_callback.py:55-147) re-derived for param
    pytrees instead of named_parameters."""
    leaves = _conv_leaves(params)
    snakes: dict[str, list] = {}
    cur: list = []
    cur_names: list[str] = []
    last_dim = None

    def close():
        nonlocal cur, cur_names, last_dim
        if cur:
            import os.path as _osp

            name = _osp.commonprefix(cur_names).strip(".") or cur_names[0]
            base = name
            n = 2
            while name in snakes:
                name = f"{base}_{n}"
                n += 1
            snakes[name] = cur
        cur, cur_names, last_dim = [], [], None

    for name, w2, bias in leaves:
        if last_dim is not None and last_dim != w2.shape[1]:
            close()
        cur_names.append(name)
        # a bias stacked over ensemble members (ndim 2) is left out, as the
        # JAX function leaves it out when its member count is not the
        # channel count (where it is, the JAX function raises)
        if bias is not None and bias.ndim == 1 and w2.shape[0] == bias.shape[0]:
            cur.append((w2, bias))
            last_dim = w2.shape[0]
        else:
            cur.append((w2, None))
            close()
    close()

    images = {}
    for snake_name, snake in snakes.items():
        values = np.concatenate(
            [np.concatenate([w.reshape(-1)] + ([b.reshape(-1)] if b is not None else []))
             for w, b in snake]
        )
        vmin, vmax = float(values.min()), float(values.max())
        wide = snake[0::2]
        high = snake[1::2]
        height = wide[0][0].shape[1]
        width = 0
        for i in range(len(wide)):
            w_w, b_w = wide[i]
            width += w_w.shape[0]
            if b_w is not None:
                height += 1
            if i < len(high):
                w_h, b_h = high[i]
                height += w_h.shape[0]
                if b_h is not None:
                    width += 1
        img = np.full((width, height), vmin, np.float32)
        cw = ch = 0
        for i in range(len(wide)):
            w_w, b_w = wide[i]
            lw, lh = w_w.shape
            img[cw : cw + lw, ch : ch + lh] = w_w
            ch += lh
            if b_w is not None:
                img[:, ch] = vmax
                img[cw : cw + lw, ch] = b_w
                ch += 1
            if i < len(high):
                w_h, b_h = high[i]
                hw, hh = w_h.shape[1], w_h.shape[0]
                img[cw : cw + hw, ch : ch + hh] = w_h.T
                cw += hw
                if b_h is not None:
                    img[cw, :] = vmax
                    img[cw, ch : ch + hh] = b_h
                    cw += 1
        images[snake_name] = img
    return images


def log_model_parameters(writer, variables, step: int,
                         max_leaf_histograms: int | None = 256) -> None:
    """Reference-shaped parameter logging
    (validation_visualization_callback.py:42-53): one all-params histogram
    per model, per-parameter histograms, and snake weight-matrix images per
    model.

    ``max_leaf_histograms`` bounds the per-parameter histogram count per
    model (the device_get + add_histogram of every leaf at production scale
    — 26.4M params over ~15 models — stalls a 1-core host for minutes per
    validation), so the default is NOT strict reference parity: leaves past
    the cap (tree order) are dropped, and a
    ``models/{name}/histograms_dropped`` scalar records how many. The
    per-model all-params histogram and snake images are always emitted.
    Pass None for strict unbounded reference parity."""
    for name, params in _model_param_trees(variables).items():
        leaves = [("/".join(str(p) for p in path), np.asarray(leaf))
                  for path, leaf in leaves_with_path(params)]
        if not leaves:
            continue
        writer.add_histogram(
            rank(f"models/{name}"),
            np.concatenate([l.reshape(-1) for _, l in leaves]),
            step,
        )
        capped = leaves if max_leaf_histograms is None else leaves[:max_leaf_histograms]
        if len(capped) < len(leaves):
            writer.add_scalar(
                rank(f"models/{name}/histograms_dropped"), len(leaves) - len(capped), step
            )
        for keys, leaf in capped:
            writer.add_histogram(rank(f"models/{name}/{keys}"), leaf.reshape(-1), step)
        images = parameter_snake_images(params) if plotting.available() else {}
        for snake_name, img in images.items():
            add_figure(writer, rank(f"models/{name}/{snake_name}"), plotting.plot_image, img, step)


class ModelGraphVisualizationCallback(Callback):
    """One-shot model structure dump (reference
    gan_models_graph_visualization_callback.py logs torch graphs; here a
    parameter summary text per model)."""

    def __init__(self, summaries: dict[str, str]):
        self.summaries = summaries  # {model_name: summary text}

    def on_init_end(self, loop: TrainLoop) -> None:
        if loop.writer is None or loop.global_step > 0:
            return
        for name, text in self.summaries.items():
            loop.writer.add_text(f"model_graph/{name}", f"```\n{text}\n```", 0)
