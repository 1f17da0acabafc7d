"""The two comparison baselines the evaluation harness co-runs
(``deeprest_tpu/models/baselines.py``).

Semantics replicate the reference line-for-line-comparable behavior
(reference: resource-estimation/baselines.py) so MAE tables stay
apples-to-apples (SURVEY.md §7.1 step 5):

- **ResourceAware** — history-only MLP: trains on (resource window at
  t−offset → resource window at t) pairs, then predicts a *single* window
  from a fixed train-time input and repeats it for every test step
  (reference: baselines.py:40-77).  Here in torch, on an explicit device.
- **ComponentAware** — linear rescaling of the component's invocation-count
  series onto the metric's train-split range
  (reference: baselines.py:80-110), falling back to the total request count
  when a component never appears in traces (reference: baselines.py:86).
  Numpy, copied as it is.

Every metric's MLP starts from the same initial weights (one seed) and sees
its pairs in the same order (one ``np.random.default_rng(seed)`` over the
same pair count), so :func:`baseline_predictions` trains all E of them as
one batched ``[E, ...]`` model: ``torch.bmm`` over the expert axis and an
elementwise Adam compute for each metric what its own run computes.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from deeprest_tpu_torch.data.windows import minmax_fit
from deeprest_tpu_torch.device import resolve_device

MLP_LEAVES = ("w1", "b1", "w2", "b2")


def init_mlp_params(window_size: int, hidden_size: int,
                    seed: int) -> dict[str, torch.Tensor]:
    """One MLP's initial weights with the JAX package's bounds: ``w1 [W,
    H]`` and ``b1 [H]`` from U(±1/√W), ``w2 [H, W]`` and ``b2 [W]`` from
    U(±1/√H), drawn in that order from a ``torch.Generator`` seeded with
    ``seed`` (CPU float32 tensors; the stream is torch's, not JAX's)."""
    gen = torch.Generator().manual_seed(int(seed))
    s1, s2 = 1.0 / np.sqrt(window_size), 1.0 / np.sqrt(hidden_size)

    def uniform(shape, bound):
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return (u * 2.0 - 1.0) * float(bound)

    return {"w1": uniform((window_size, hidden_size), s1),
            "b1": uniform((hidden_size,), s1),
            "w2": uniform((hidden_size, window_size), s2),
            "b2": uniform((window_size,), s2)}


def mlp_forward(params: Mapping[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """``[E, n, W]`` → ``[E, n, W]``: ``relu(x @ w1 + b1) @ w2 + b2`` per
    expert, the leaves carrying a leading ``[E]`` axis."""
    hidden = torch.relu(torch.bmm(x, params["w1"]) + params["b1"][:, None])
    return torch.bmm(hidden, params["w2"]) + params["b2"][:, None]


def _adam_update(params, grads, mu, nu, count: int, lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One ``optax.adam(lr)`` step in place, in optax's order of operations:
    moments ``(1-b)·g + b·m``, bias correction by ``1 - b**count``, update
    ``-lr · m̂ / (√v̂ + eps)`` added to the parameter.  The corrections are
    float32 host scalars, so a step queues no host-to-device copy."""
    one = np.float32(1.0)
    bc1 = float(one - np.float32(b1) ** np.float32(count))
    bc2 = float(one - np.float32(b2) ** np.float32(count))
    for k in MLP_LEAVES:
        g = grads[k]
        mu[k] = (1.0 - b1) * g + b1 * mu[k]
        nu[k] = (1.0 - b2) * (g * g) + b2 * nu[k]
        m_hat = mu[k] / bc1
        v_hat = nu[k] / bc2
        params[k] = params[k] + (m_hat / (torch.sqrt(v_hat) + eps)) * (-lr)


@dataclasses.dataclass
class ResourceAwareBaseline:
    """History-only MLP baseline (no traffic input), on ``device`` (None
    means ``"cuda"``, which raises without a GPU)."""

    split: int
    window_size: int
    offset: int | None = None          # default: window_size - 1, as reference
    hidden_size: int = 128
    num_epochs: int = 100
    batch_size: int = 32
    learning_rate: float = 1e-3
    seed: int = 0
    device: str | torch.device | None = None

    def fit_and_estimate(self, y: np.ndarray,
                         init_params: Mapping | None = None) -> np.ndarray:
        """y: [N, W, 1] windowed metric series → [N - split, W, 1] estimates."""
        return self.fit_and_estimate_many(y[None], init_params)[0]

    def fit_and_estimate_many(self, ys: np.ndarray,
                              init_params: Mapping | None = None
                              ) -> np.ndarray:
        """ys: [E, N, W, 1], one windowed series per metric → [E, N - split,
        W, 1] estimates, all E MLPs trained as one batched model.

        ``init_params`` (the four leaves of ONE MLP, e.g. the JAX package's
        through ``interop.baseline_params_from_jax``) replaces the seeded
        initialization; every metric starts from it, as every metric of
        the JAX package starts from ``PRNGKey(seed)``."""
        offset = self.offset if self.offset is not None else self.window_size - 1
        stats = [minmax_fit(y, split=self.split) for y in ys]
        y_n = np.stack([s.apply(y).astype(np.float32)
                        for s, y in zip(stats, ys)])          # [E, N, W, 1]

        # (input window at i-offset, target window at i) pairs.
        inputs = y_n[:, :-offset, :, 0] if offset > 0 else y_n[:, :, :, 0]
        targets = y_n[:, offset:, :, 0]
        split_local = self.split - offset
        x_train, t_train = inputs[:, :split_local], targets[:, :split_local]

        params = self._train(x_train, t_train, init_params)

        # Predict one window from the fixed train-time input the reference
        # uses (pair index split_local - offset, i.e. series index
        # split - 2*offset; reference: baselines.py:69-71) and repeat it.
        probe_idx = max(split_local - offset, 0)
        device = params["w1"].device
        with torch.no_grad():
            probe = torch.from_numpy(
                np.ascontiguousarray(inputs[:, probe_idx:probe_idx + 1])
            ).to(device)
            pred = mlp_forward(params, probe)[:, 0].cpu().numpy()  # [E, W]
        num_test = ys.shape[1] - self.split
        return np.stack([
            np.tile(np.maximum(s.invert(p), 1e-6), (num_test, 1))[:, :, None]
            for s, p in zip(stats, pred)])

    # -- internals ---------------------------------------------------------

    def _init_params(self, num_models: int, init_params: Mapping | None,
                     device: torch.device) -> dict[str, torch.Tensor]:
        if init_params is None:
            init_params = init_mlp_params(self.window_size, self.hidden_size,
                                          self.seed)
        out = {}
        for k in MLP_LEAVES:
            leaf = torch.as_tensor(init_params[k], dtype=torch.float32)
            out[k] = leaf.to(device).expand(num_models, *leaf.shape).clone()
        return out

    def _train(self, x_train: np.ndarray, t_train: np.ndarray,
               init_params: Mapping | None = None) -> dict[str, torch.Tensor]:
        """Adam (optax defaults) on the mean squared error of each model,
        ``x_train``/``t_train`` ``[E, n, W]``; one shuffled order per epoch
        from ``np.random.default_rng(seed)``, shared by all E models."""
        device = resolve_device(self.device)
        params = self._init_params(len(x_train), init_params, device)
        n = x_train.shape[1]
        if n == 0:
            return params
        x_dev = torch.from_numpy(np.ascontiguousarray(x_train)).to(device)
        t_dev = torch.from_numpy(np.ascontiguousarray(t_train)).to(device)
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        count = 0
        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_epochs):
            order = rng.permutation(n)
            for lo in range(0, n, self.batch_size):
                sel = torch.from_numpy(order[lo:lo + self.batch_size]).to(
                    device)
                xb, tb = x_dev[:, sel], t_dev[:, sel]
                leaves = {k: v.requires_grad_(True) for k, v in params.items()}
                # each model's loss is its own mean; the sum leaves every
                # model's gradient exactly its own
                loss = ((mlp_forward(leaves, xb) - tb) ** 2).mean(
                    dim=(1, 2)).sum()
                grads = dict(zip(MLP_LEAVES, torch.autograd.grad(
                    loss, [leaves[k] for k in MLP_LEAVES])))
                count += 1
                with torch.no_grad():
                    params = {k: v.detach() for k, v in leaves.items()}
                    _adam_update(params, grads, mu, nu, count,
                                 self.learning_rate)
        return params


def component_scaling_fit(inv_train: np.ndarray,
                          metric_train: np.ndarray) -> tuple:
    """The reference's four scaling weights from a train split
    (reference: baselines.py:97-104): min invocations, metric range,
    invocation range, metric floor."""
    return (
        float(np.min(inv_train)),
        float(np.max(metric_train) - np.min(metric_train)),
        float(np.max(inv_train) - np.min(inv_train)),
        float(np.min(metric_train)),
    )


def component_scaling_apply(inv: np.ndarray, weights: tuple) -> np.ndarray:
    """``(inv − w1)·w2/w3 + w4`` with the reference's branches
    (reference: baselines.py:105-109; the degenerate w3=0 case divides by
    zero there — pinned to the train-split floor instead)."""
    w1, w2, w3, w4 = weights
    if inv.sum() > 0 and w3 > 0:
        ts_hat = (inv - w1) * w2 / w3 + w4
    elif inv.sum() > 0:
        ts_hat = np.full_like(inv, w4)
    else:
        ts_hat = np.asarray(inv, dtype=np.float64)
    return np.maximum(ts_hat, 1e-6)


@dataclasses.dataclass
class ComponentAwareBaseline:
    """Linear invocation-count → metric-range rescaling baseline."""

    split: int
    window_size: int
    component: str
    invocations: Mapping[str, np.ndarray]

    def fit_and_estimate(self, y: np.ndarray) -> np.ndarray:
        """y: [N, W, 1] windowed metric series → [N - split, W, 1] estimates."""
        w = self.window_size
        inv = self.invocations[
            self.component if self.component in self.invocations else "general"
        ]
        inv = np.asarray(inv, dtype=np.float64)

        # Reassemble the un-windowed series: first element of every window
        # but the last, then the whole last window (reference:
        # baselines.py:95) — length T-1 for T raw buckets.
        ts = np.concatenate([y[:-1, 0, 0], y[-1, :, 0]])

        split_series = self.split + w - 1
        weights = component_scaling_fit(inv[:split_series], ts[:split_series])
        ts_hat = component_scaling_apply(inv, weights)

        windows = np.asarray([ts_hat[i - w:i] for i in range(w, len(ts) + 1)])
        return windows[self.split:][:, :, None]


def baseline_predictions(data, bundle, resource_epochs: int = 100,
                         device=None,
                         init_params: Mapping | None = None
                         ) -> dict[str, np.ndarray]:
    """Both baselines on every metric, aligned with ``bundle``'s test windows.

    Returns ``{"resrc"|"comp": [N_test, W, E]}`` de-normalized predictions —
    the two comparison columns of the reference's per-epoch eval table
    (reference: estimate.py:31-39,112-122).  The E ResourceAware MLPs train
    as one batched model on ``device`` (None means ``"cuda"``).
    """
    from deeprest_tpu_torch.data.windows import sliding_windows

    w = bundle.window_size
    targets = data.targets()
    ys = np.stack([sliding_windows(targets[:, [idx]], w)      # [E, N, W, 1]
                   for idx in range(len(bundle.metric_names))])
    resrc = ResourceAwareBaseline(
        split=bundle.split, window_size=w, num_epochs=resource_epochs,
        device=device).fit_and_estimate_many(ys, init_params)
    comp = [
        ComponentAwareBaseline(split=bundle.split, window_size=w,
                               component=name.rsplit("_", 1)[0],
                               invocations=data.invocations
                               ).fit_and_estimate(ys[idx])
        for idx, name in enumerate(bundle.metric_names)
    ]
    return {
        "resrc": np.concatenate(list(resrc), axis=-1),
        "comp": np.concatenate(comp, axis=-1),
    }
