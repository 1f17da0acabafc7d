"""Build the demo's precomputed what-if results artifact
(``deeprest_tpu/demo/precompute.py``; the same schema and seeds, so both
packages write the same artifact from the same checkpoint up to the
model's predictions).

The reference demo reads an opaque ``results.pkl`` whose generator is not
in the repo (reference: web-demo/dataloader.py:30-32, missing large blob);
this module is that missing piece, built on the framework's own stack: for
every (load shape × multiplier × API composition) dataset it

1. draws a hypothetical traffic program (users curve × composition),
2. generates the matching span-tree workload with the simulated app and
   runs the stateful resource model over it → **ground truth** (the
   reference needed a real cluster run per dataset),
3. estimates utilization from the synthesized traffic features with the
   trained quantile model → **ours**,
4. co-computes both reference baselines on the same program: history-
   replay (resource-aware) and invocation-count linear scaling
   (component-aware),
5. records peak scaling factors vs the observed baseline period, with the
   memory/usage re-anchoring rule (reference: web-demo/
   dataloader.py:143-156) applied at precompute time.

Output schema (JSON, gzip when the path ends in .gz):

    {"meta": {...}, "datasets": {key: {"calls": {api: [T]},
      "components": {comp: {resource: record}}}}}

record = {"groundtruth": [T], "ours": [T], "ours_lo": [T], "ours_hi": [T],
          "resrc": [T], "comp": [T], "observed": [T_obs],
          "scale": {method: float}}
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import zlib
from typing import Sequence

import numpy as np

from deeprest_tpu_torch.data.featurize import (
    FeaturizedData, count_invocations,
)
from deeprest_tpu_torch.data.synthesize import TraceSynthesizer
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.workload.scenarios import (
    SEEN_COMPOSITIONS, UNSEEN_COMPOSITIONS, LoadScenario,
)
from deeprest_tpu_torch.workload.telemetry import ResourceModel, count_ops
from deeprest_tpu_torch.workload.topology import (
    API_ENDPOINTS, AppParams, SocialNetworkApp,
)

# Resources whose absolute level depends on history the traffic cannot see
# (cumulative disk usage, resident memory): re-anchored before scaling.
REANCHOR_RESOURCES = ("memory", "usage")


@dataclasses.dataclass(frozen=True)
class DemoConfig:
    """Dataset grid; the default mirrors the reference demo's options
    (reference: web-demo/dataloader.py:6-28,34-49 — waves 1-3x over seen +
    unseen compositions, flat 1x over seen)."""

    shapes: tuple[str, ...] = ("waves", "flat")
    multipliers: tuple[int, ...] = (1, 2, 3)
    seen: tuple[tuple[float, float, float], ...] = SEEN_COMPOSITIONS[:9]
    unseen: tuple[tuple[float, float, float], ...] = UNSEEN_COMPOSITIONS
    ticks: int = 120
    components: tuple[str, ...] = ()   # () = every checkpointed component
    base_users: float = 100.0
    calls_per_user: float = 2.0
    seed: int = 7

    def dataset_keys(self) -> list[tuple[str, int, str, int]]:
        """(shape, multiplier, seen|unseen, index) — flat is 1x/seen-only,
        matching the reference's option wiring."""
        keys = []
        for shape in self.shapes:
            mults = self.multipliers if shape == "waves" else (1,)
            groups = ("seen", "unseen") if shape == "waves" else ("seen",)
            for mult in mults:
                for group in groups:
                    comps = self.seen if group == "seen" else self.unseen
                    keys.extend((shape, mult, group, i)
                                for i in range(len(comps)))
        return keys

    def composition(self, group: str, index: int) -> tuple[float, float, float]:
        return (self.seen if group == "seen" else self.unseen)[index]


def dataset_name(shape: str, mult: int, group: str, index: int) -> str:
    return f"{shape}-{mult}x-{group}-{index}"


def _api_root_labels(app: SocialNetworkApp) -> dict[str, str]:
    """Root span label of each API's primary trace (probabilistic side
    traces like the media upload surface as their own endpoints)."""
    rng = np.random.default_rng(0)
    return {api: app.generate(api, rng)[0].label for api in API_ENDPOINTS}


def _traffic_program(cfg: DemoConfig, shape: str, mult: int,
                     comp: tuple[float, float, float],
                     rng: np.random.Generator) -> np.ndarray:
    """[ticks, num_apis] integer calls: users curve × fixed composition."""
    scn = LoadScenario(
        name="demo", flat=shape != "waves",
        base_users=cfg.base_users * mult,
        peak_range=(1.4 * cfg.base_users * mult, 2.0 * cfg.base_users * mult),
        seed=cfg.seed,
    )
    users = scn.users_curve(cfg.ticks)
    compose, read_home, read_user = comp
    rest = max(0.0, 1.0 - compose - read_home - read_user)
    w = np.asarray([compose, read_home, read_user,
                    rest * 0.2, rest * 0.3, rest * 0.5])
    rates = users[:, None] * cfg.calls_per_user * (w / w.sum())
    return rng.poisson(rates).astype(np.int64)


def _reanchor(series: np.ndarray, anchor: float) -> np.ndarray:
    return series - series[0] + anchor


def precompute_results(
    predictor: Predictor,
    observed: FeaturizedData,
    observed_buckets: Sequence,
    config: DemoConfig | None = None,
    app_params: AppParams | None = None,
) -> dict:
    """The full results artifact.

    Args:
      predictor: restored from a checkpoint trained on ``observed`` (its
        device runs the estimates: K1 on a GPU).
      observed: the featurized training corpus (baseline period).
      observed_buckets: its raw buckets (fits the trace synthesizer).
      config: dataset grid.
      app_params: branch probabilities for the ground-truth workload.
    """
    cfg = config or DemoConfig()
    app = SocialNetworkApp(app_params)
    roots = _api_root_labels(app)
    p_media = (app_params or AppParams()).p_media

    space = predictor.space()
    if space is None:
        raise ValueError("checkpoint predates sidecar feature spaces; "
                         "re-train to use the demo")
    synth = TraceSynthesizer(space).fit(list(observed_buckets))

    metric_names = predictor.metric_names
    if list(observed.metric_names) != list(metric_names):
        # anchors/baselines/scales index observed columns by checkpoint
        # metric order — a mismatched corpus would silently mix columns
        raise ValueError(
            "observed corpus metric set/order does not match the "
            "checkpoint's; pass the corpus the model was trained on"
        )
    components = sorted({m.rsplit("_", 1)[0] for m in metric_names})
    if cfg.components:
        components = [c for c in components if c in cfg.components]
    med = predictor.median_index()

    observed_targets = observed.targets()         # [T_obs, E] raw scale
    obs_peak = np.max(np.abs(observed_targets), axis=0)      # [E]
    obs_last = observed_targets[-1]                          # [E] anchors
    w = predictor.window_size

    datasets = {}
    for shape, mult, group, index in cfg.dataset_keys():
        comp3 = cfg.composition(group, index)
        key = dataset_name(shape, mult, group, index)
        # process-stable per-dataset stream (hash() is salted per process)
        rng = np.random.default_rng(cfg.seed + zlib.crc32(key.encode()))
        calls = _traffic_program(cfg, shape, mult, comp3, rng)

        # -- ground truth: simulated workload + resource model ------------
        per_tick_traces = []
        for t in range(cfg.ticks):
            traces = []
            for a, api in enumerate(API_ENDPOINTS):
                for _ in range(int(calls[t, a])):
                    traces.extend(app.generate(api, rng))
            per_tick_traces.append(traces)
        model = ResourceModel(seed=cfg.seed)
        comp_set = sorted({c for m in metric_names
                           for c in [m.rsplit("_", 1)[0]]})
        truth = {m: np.zeros(cfg.ticks, np.float32) for m in metric_names}
        for t, traces in enumerate(per_tick_traces):
            ops, writes = count_ops(traces)
            for sample in model.step_counts(ops, writes, components=comp_set):
                if sample.key in truth:
                    truth[sample.key][t] = sample.value

        # -- ours: synthesized features → quantile model ------------------
        mix_series = []
        for t in range(cfg.ticks):
            mix = {}
            for a, api in enumerate(API_ENDPOINTS):
                n = int(calls[t, a])
                if n and roots[api] in synth.endpoints:
                    mix[roots[api]] = mix.get(roots[api], 0) + n
            n_media = int(rng.binomial(int(calls[t, 0]), p_media))
            media_eps = [e for e in synth.endpoints if "media" in e]
            if n_media and media_eps:
                mix[media_eps[0]] = mix.get(media_eps[0], 0) + n_media
            mix_series.append(mix)
        x = synth.synthesize_series(mix_series, seed=cfg.seed + index)
        preds = predictor.predict_series(x)        # [ticks, E, Q]

        # -- baselines on the same program --------------------------------
        # history replay: the last observed window, tiled (reference:
        # baselines.py:69-77 "repeat one window for every test step")
        reps = int(np.ceil(cfg.ticks / w))
        resrc_all = np.tile(observed_targets[-w:], (reps, 1))[:cfg.ticks]
        # invocation-count linear scaling onto the observed metric range
        inv_hyp = np.zeros((cfg.ticks, len(components)), np.float64)
        comp_idx = {c: i for i, c in enumerate(components)}
        for t, traces in enumerate(per_tick_traces):
            for c, n in count_invocations(traces).items():
                if c in comp_idx:
                    inv_hyp[t, comp_idx[c]] = n

        comp_records = {}
        for c in components:
            res_records = {}
            for m_i, metric in enumerate(metric_names):
                m_comp, resource = metric.rsplit("_", 1)
                if m_comp != c:
                    continue
                obs_series = observed_targets[:, m_i]
                inv_obs = observed.invocations.get(
                    c, observed.invocations.get("general"))
                # reference scaling weights (baselines.py:88-107) on the
                # full observed (baseline) period
                w1, w3 = np.min(inv_obs), np.ptp(inv_obs)
                w2, w4 = np.ptp(obs_series), np.min(obs_series)
                inv_h = inv_hyp[:, comp_idx[c]]
                comp_pred = ((inv_h - w1) * w2 / max(w3, 1e-9) + w4
                             if w3 > 0 else np.full(cfg.ticks, w4))

                series = {
                    "groundtruth": truth[metric].astype(np.float64),
                    "ours": preds[:, m_i, med].astype(np.float64),
                    "ours_lo": preds[:, m_i, 0].astype(np.float64),
                    "ours_hi": preds[:, m_i, -1].astype(np.float64),
                    "resrc": resrc_all[:, m_i].astype(np.float64),
                    "comp": np.asarray(comp_pred, np.float64),
                }
                if resource in REANCHOR_RESOURCES:
                    anchor = float(obs_last[m_i])
                    series = {k: _reanchor(v, anchor)
                              for k, v in series.items()}
                peak_obs = max(float(obs_peak[m_i]), 1e-9)
                scale = {k: float(np.max(np.abs(v)) / peak_obs)
                         for k, v in series.items()
                         if k not in ("ours_lo", "ours_hi")}
                rec = {k: np.round(v, 5).tolist() for k, v in series.items()}
                rec["observed"] = np.round(
                    obs_series[-2 * w:], 5).tolist()
                rec["scale"] = scale
                res_records[resource] = rec
            if res_records:
                comp_records[c] = res_records

        datasets[key] = {
            "shape": shape, "multiplier": mult, "group": group,
            "index": index, "composition": list(comp3),
            "calls": {api: calls[:, a].tolist()
                      for a, api in enumerate(API_ENDPOINTS)},
            "components": comp_records,
        }

    return {
        "meta": {
            "apis": list(API_ENDPOINTS),
            "components": components,
            "resources": sorted({m.rsplit("_", 1)[1] for m in metric_names}),
            "shapes": list(cfg.shapes),
            "multipliers": list(cfg.multipliers),
            "compositions": {"seen": [list(c) for c in cfg.seen],
                             "unseen": [list(c) for c in cfg.unseen]},
            "ticks": cfg.ticks,
            "window_size": w,
            "methods": ["groundtruth", "resrc", "comp", "ours"],
        },
        "datasets": datasets,
    }


def save_results(results: dict, path: str) -> str:
    payload = json.dumps(results).encode()
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
    return path
