"""``Config`` parity with the JAX package (``deeprest_tpu/config.py``).

- Every section's fields and defaults are JAX's, and a JAX
  ``Config().to_json()`` loads in the port and writes back the same text;
  so does the flagship's config (B=32, T=60, F=512, E=40, H=128,
  bidirectional, bf16, with a mesh and non-default sections).
- An unknown key raises JAX's message; JSON lists become tuples;
  ``replace`` keeps the other sections.
- ``MeshConfig.parse`` and ``size`` as JAX's, with JAX's messages.
"""

import dataclasses
import json

import pytest

import deeprest_tpu.config as jax_config
from deeprest_tpu_torch import config

SECTIONS = ("model", "train", "featurize", "mesh", "etl", "infer", "obs",
            "quality", "surface", "fleet")


def flagship(cfg_module):
    c = cfg_module
    return c.Config(
        model=c.ModelConfig(feature_dim=512, num_metrics=40, hidden_size=128,
                            compute_dtype="bfloat16"),
        train=c.TrainConfig(batch_size=32, window_size=60,
                            steps_per_superstep=10, grad_accum_windows=2,
                            checkpoint_dir="ckpt", snapshot_every_steps=50,
                            delta_resources=("usage", "wthroughput")),
        featurize=c.FeaturizeConfig(capacity=512, hash_features=True),
        mesh=c.MeshConfig(data=2),
        infer=c.InferConfig(quant="int8", page_windows=64),
        obs=c.ObsConfig(enabled=True, span_capacity=128),
        surface=c.SurfaceConfig(enabled=True, grid=(0.5, 1.0, 3.0)),
        fleet=c.FleetConfig(enabled=True, hbm_budget=16))


def test_sections_fields_and_defaults_are_jaxs():
    assert [f.name for f in dataclasses.fields(config.Config)] == [
        f.name for f in dataclasses.fields(jax_config.Config)] == list(
        SECTIONS)
    for f in dataclasses.fields(jax_config.Config):
        want = dataclasses.asdict(f.default_factory())
        got = dataclasses.asdict(getattr(config, f.default_factory.__name__)())
        assert got == want, f.name


@pytest.mark.parametrize("which", ["default", "flagship"])
def test_jax_config_json_round_trips_bit_equal(which):
    jcfg = (jax_config.Config() if which == "default"
            else flagship(jax_config))
    text = jcfg.to_json()
    port = config.Config.from_json(text)
    assert port.to_json() == text
    if which == "flagship":
        assert port == flagship(config)
        assert port.train.delta_resources == ("usage", "wthroughput")
        assert port.surface.grid == (0.5, 1.0, 3.0)
        assert port.mesh.size == 2
    # and back: the port's JSON loads in the JAX package
    assert jax_config.Config.from_json(port.to_json()) == jcfg
    assert list(json.loads(text)) == sorted(SECTIONS)


@pytest.mark.parametrize("section,key", [("mesh", "pipeline"),
                                         ("train", "epochs"),
                                         ("obs", "spans")])
def test_unknown_key_raises_jax_message(section, key):
    d = {section: {key: 1}}
    with pytest.raises(ValueError) as jax_err:
        jax_config.Config.from_dict(d)
    with pytest.raises(ValueError) as port_err:
        config.Config.from_dict(d)
    assert str(port_err.value) == str(jax_err.value)
    assert f"keys: [{key!r}]" in str(port_err.value)


def test_replace_keeps_the_other_sections():
    base = flagship(config)
    new = base.replace(mesh=config.MeshConfig(data=4),
                       obs=config.ObsConfig())
    assert new.mesh.data == 4 and not new.obs.enabled
    for name in SECTIONS:
        if name not in ("mesh", "obs"):
            assert getattr(new, name) is getattr(base, name), name
    assert config.Config.from_dict({}) == config.Config()


@pytest.mark.parametrize("spec", ["2,1,1", "1,2,4", "2,x,1", "1,1", "0,1,1",
                                  "1,1,-3", ""])
def test_mesh_parse_matches_jax(spec):
    try:
        want = jax_config.MeshConfig.parse(spec)
    except ValueError as exc:
        with pytest.raises(ValueError) as port_err:
            config.MeshConfig.parse(spec)
        assert str(port_err.value) == str(exc)
        return
    got = config.MeshConfig.parse(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.size == want.size


def test_validation_messages_match_jax():
    for cls, kw in ((config.ObsConfig, dict(span_capacity=0)),
                    (config.TrainConfig, dict(remesh_max_attempts=0)),
                    (config.TrainConfig, dict(remesh_backoff_ms=-1.0))):
        with pytest.raises(ValueError) as port_err:
            cls(**kw)
        with pytest.raises(ValueError) as jax_err:
            getattr(jax_config, cls.__name__)(**kw)
        assert str(port_err.value) == str(jax_err.value)
