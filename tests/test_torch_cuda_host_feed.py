"""The host-streamed trainer feed (train/graphs.py ``HostFeed``) on the card.

Needs an NVIDIA GPU and nvcc (the captured update launches K2 and K3,
which have no CPU mode); without CUDA every test here skips.  Run on the
card (the repository's conftest imports JAX, which the GPU machine does
not have):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_host_feed.py

Host-fed training (``device_data="off"``) must equal the staged feed bit
for bit, eager (S = 1) and captured (S = 2, the pinned ring reused many
times over two epochs), f32 and bf16, dropout 0.5; and a host-fed epoch of
replays must not synchronize the device per step.
"""

import numpy as np
import pytest
import torch

from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData
from deeprest_tpu_torch.train.data import prepare_dataset
from deeprest_tpu_torch.train.trainer import Trainer

F, E, H, W, T = 24, 5, 64, 12, 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the update launches K2 and K3, "
                    "which have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def corpus() -> FeaturizedData:
    rng = np.random.default_rng(0)
    traffic = rng.poisson(5.0, (T, F)).astype(np.float32)
    resources = {}
    for i in range(E):
        w = rng.uniform(0.0, 1.0, F)
        level = traffic @ w + rng.normal(0.0, 1.0, T)
        res = "usage" if i == E - 1 else "cpu"
        if res == "usage":
            level = np.cumsum(np.abs(level)) / T
        resources[f"c{i}_{res}"] = level.astype(np.float32)
    space = {"config": {"capacity": 0, "round_to": 8,
                        "hash_features": False, "hash_seed": 0},
             "vocabulary": [["s", f"/op{j}"] for j in range(F)],
             "frozen_capacity": F}
    return FeaturizedData(traffic=traffic, resources=resources,
                          invocations={},
                          space=CallPathSpace.from_dict(space))


def run(device_data: str, compute: str, superstep: int):
    cfg = Config(model=ModelConfig(hidden_size=H, dropout_rate=0.5,
                                   compute_dtype=compute),
                 train=TrainConfig(batch_size=16, window_size=W,
                                   eval_stride=W, eval_max_cycles=4,
                                   num_epochs=2, log_every_steps=0,
                                   steps_per_superstep=superstep,
                                   device_data=device_data))
    bundle = prepare_dataset(corpus(), cfg.train)
    trainer = Trainer(cfg, F, bundle.metric_names, device="cuda")
    losses = []
    state, hist = trainer.fit(bundle, state=trainer.init_state(seed=3),
                              on_epoch=lambda r, s: losses.append(
                                  trainer.last_epoch_losses))
    return trainer, state, hist, np.concatenate(losses), bundle


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("superstep", [1, 2])
def test_host_fed_bit_identical_to_staged_on_the_card(cuda, compute,
                                                      superstep):
    host = run("off", compute, superstep)
    staged = run("always", compute, superstep)
    assert (host[0].feed, staged[0].feed) == ("host", "staged")
    assert host[0].captures == staged[0].captures == (
        1 if superstep > 1 else 0)
    np.testing.assert_array_equal(host[3], staged[3])
    for name, value in staged[1].params.items():
        assert torch.equal(host[1].params[name], value), name
    assert [h.test_loss for h in host[2]] == [h.test_loss for h in staged[2]]


@pytest.mark.cuda
def test_host_fed_epoch_never_synchronizes_per_step(cuda, monkeypatch):
    trainer, state, _, _, bundle = run("off", "bfloat16", 2)
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (calls.append(1), real(*a, **k)))
    real_stream = torch.cuda.Stream.synchronize
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        lambda self: (calls.append(2), real_stream(self)))
    replays = trainer.replays
    trainer.train_epoch(state, bundle, np.random.default_rng(0))
    steps = trainer.replays - replays
    assert steps == -(-bundle.num_train_windows // 16) > 2
    # the throughput window's end waits once; nothing else does
    assert calls == [1]
