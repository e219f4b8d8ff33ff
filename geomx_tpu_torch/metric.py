"""Evaluation metrics.

Mirrors the reference's metric library surface
(``python/mxnet/metric.py``): ``EvalMetric`` base with
``update(labels, preds)`` / ``reset()`` / ``get()``, the standard
classification and regression metrics, a composite container, and a
``create`` factory by name. Arrays are numpy, or torch tensors on any
device (read back to the host); predictions follow the mxnet convention
(class scores along the last axis, or hard labels when the shapes
already match). Counterpart of ``geomx_tpu/metric.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MAE", "MSE", "RMSE",
    "CrossEntropy", "Perplexity", "Loss", "CompositeEvalMetric", "create",
]


def _to_np(x) -> np.ndarray:
    if hasattr(x, "detach"):            # a torch tensor, on any device
        x = x.detach()
        if x.dtype == torch.bfloat16:   # numpy has no bfloat16
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _as_list(x) -> List:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _pred_labels(pred: np.ndarray, label: np.ndarray) -> np.ndarray:
    """Hard labels from scores (argmax over last axis) or passthrough."""
    if pred.ndim == label.ndim + 1:
        return np.argmax(pred, axis=-1)
    return pred


class EvalMetric:
    """Base metric (reference: metric.py EvalMetric)."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds) -> None:
        raise NotImplementedError

    def get(self) -> Tuple[str, float]:
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self) -> List[Tuple[str, float]]:
        return [self.get()]

    def update_batch(self, labels, preds) -> None:
        """Convenience: update from (possibly) lists of arrays."""
        for l, p in zip(_as_list(labels), _as_list(preds)):
            self.update(l, p)


class Accuracy(EvalMetric):
    def __init__(self, name: str = "accuracy"):
        super().__init__(name)

    def update(self, labels, preds) -> None:
        label = _to_np(labels).astype(np.int64).ravel()
        pred = _pred_labels(_to_np(preds), _to_np(labels))
        pred = _to_np(pred).astype(np.int64).ravel()
        self.sum_metric += float((pred == label).sum())
        self.num_inst += label.size


class TopKAccuracy(EvalMetric):
    def __init__(self, top_k: int = 5, name: Optional[str] = None):
        self.top_k = top_k
        super().__init__(name or f"top_k_accuracy_{top_k}")

    def update(self, labels, preds) -> None:
        label = _to_np(labels).astype(np.int64).ravel()
        pred = _to_np(preds)
        assert pred.ndim == 2, "TopKAccuracy needs (batch, classes) scores"
        k = min(self.top_k, pred.shape[1])
        topk = np.argpartition(pred, -k, axis=1)[:, -k:]
        self.sum_metric += float((topk == label[:, None]).any(axis=1).sum())
        self.num_inst += label.size


class F1(EvalMetric):
    """Binary F1 (reference: metric.py F1 — positive class is 1)."""

    def __init__(self, name: str = "f1"):
        super().__init__(name)

    def reset(self) -> None:
        super().reset()
        self._tp = self._fp = self._fn = 0

    def update(self, labels, preds) -> None:
        label = _to_np(labels).astype(np.int64).ravel()
        pred = _pred_labels(_to_np(preds), _to_np(labels))
        pred = _to_np(pred).astype(np.int64).ravel()
        self._tp += int(((pred == 1) & (label == 1)).sum())
        self._fp += int(((pred == 1) & (label == 0)).sum())
        self._fn += int(((pred == 0) & (label == 1)).sum())
        self.num_inst = 1  # get() computes from counts

    def get(self) -> Tuple[str, float]:
        prec = self._tp / (self._tp + self._fp) if self._tp + self._fp else 0.0
        rec = self._tp / (self._tp + self._fn) if self._tp + self._fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        return self.name, f1


class MAE(EvalMetric):
    def __init__(self, name: str = "mae"):
        super().__init__(name)

    def update(self, labels, preds) -> None:
        label, pred = _to_np(labels), _to_np(preds)
        self.sum_metric += float(np.abs(label - pred).sum())
        self.num_inst += label.size


class MSE(EvalMetric):
    def __init__(self, name: str = "mse"):
        super().__init__(name)

    def update(self, labels, preds) -> None:
        label, pred = _to_np(labels), _to_np(preds)
        self.sum_metric += float(np.square(label - pred).sum())
        self.num_inst += label.size


class RMSE(MSE):
    def __init__(self, name: str = "rmse"):
        super().__init__(name)

    def get(self) -> Tuple[str, float]:
        name, mse = super().get()
        return name, float(np.sqrt(mse))


class CrossEntropy(EvalMetric):
    """Mean negative log-likelihood of the true class."""

    def __init__(self, eps: float = 1e-12, name: str = "cross-entropy"):
        self.eps = eps
        super().__init__(name)

    def update(self, labels, preds) -> None:
        label = _to_np(labels).astype(np.int64).ravel()
        prob = _to_np(preds).reshape(label.size, -1)
        p = prob[np.arange(label.size), label]
        self.sum_metric += float(-np.log(np.maximum(p, self.eps)).sum())
        self.num_inst += label.size


class Perplexity(CrossEntropy):
    def __init__(self, eps: float = 1e-12, name: str = "perplexity"):
        super().__init__(eps=eps, name=name)

    def get(self) -> Tuple[str, float]:
        name, ce = super().get()
        return name, float(np.exp(ce))


class Loss(EvalMetric):
    """Mean of raw loss values (reference: metric.py Loss)."""

    def __init__(self, name: str = "loss"):
        super().__init__(name)

    def update(self, labels, preds) -> None:
        loss = _to_np(preds)
        self.sum_metric += float(loss.sum())
        self.num_inst += loss.size


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics: Optional[Sequence[EvalMetric]] = None,
                 name: str = "composite"):
        self.metrics: List[EvalMetric] = list(metrics or [])
        super().__init__(name)

    def add(self, metric: EvalMetric) -> None:
        self.metrics.append(metric)

    def reset(self) -> None:
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds) -> None:
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values

    def get_name_value(self) -> List[Tuple[str, float]]:
        return [m.get() for m in self.metrics]


_REGISTRY: Dict[str, Callable[..., EvalMetric]] = {
    "acc": Accuracy, "accuracy": Accuracy,
    "top_k_accuracy": TopKAccuracy, "top_k_acc": TopKAccuracy,
    "f1": F1, "mae": MAE, "mse": MSE, "rmse": RMSE,
    "ce": CrossEntropy, "cross-entropy": CrossEntropy,
    "perplexity": Perplexity, "loss": Loss,
}


def create(metric: Union[str, EvalMetric, Sequence], **kwargs) -> EvalMetric:
    """Factory by name (reference: metric.py create)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        return CompositeEvalMetric([create(m) for m in metric])
    name = metric.lower()
    if name not in _REGISTRY:
        raise ValueError(f"unknown metric {metric!r}; "
                         f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
