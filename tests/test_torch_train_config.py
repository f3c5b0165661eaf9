"""The port's configuration loading and learning-rate schedules against the
JAX package's, and ``chip_smoke.py``'s copies of the training
configurations against the files (the card's machine has no PyYAML)."""

from __future__ import annotations

import glob
import importlib.util
import os

import numpy as np
import pytest
import yaml

from irdu_tpu.train import schedules as jax_schedules
from irdu_tpu.train.trainer import build_schedule as jax_build_schedule
from irdu_tpu.utils import config as jax_config
from irdu_tpu_torch.train import schedules
from irdu_tpu_torch.train.trainer import build_schedule, resolve_parallel
from irdu_tpu_torch.utils import config


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_PATHS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIG_PATHS, ids=lambda p: os.path.basename(p)[:-5])
def test_load_config_matches_jax(path):
    """Every configs/*.yaml loads to JAX's dict, and pretty-prints the same."""
    ours = config.load_config(path)
    assert ours == jax_config.load_config(path)
    assert config.pretty_config(ours) == jax_config.pretty_config(ours)


OVERRIDES = [
    ["train.max_steps=800"],
    ["train.schedule.base_lr=1e-4", "eval.datasets={}"],
    ["datasets.train.csv_path=corpus/train.csv", "new.branch.leaf=[1, 2]"],
    ["model.remat=true", "train.stages.0=x", "name="],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=range(len(OVERRIDES)))
def test_apply_overrides_matches_jax(overrides):
    """YAML-parsed values (an int, a bare 1e-4 as a float, a dict, a list),
    new branches and a non-dict parent replaced by a dict, as JAX does."""
    base = os.path.join(REPO, "configs", "flagship_sigma25.yaml")
    ours = config.apply_overrides(config.load_config(base), overrides)
    assert ours == jax_config.apply_overrides(jax_config.load_config(base), overrides)


def test_bad_override_and_missing_keys_raise():
    with pytest.raises(ValueError, match="key=value"):
        config.apply_overrides({}, ["train.max_steps"])
    with pytest.raises(ValueError, match="required keys"):
        config.load_config(text="name: x\nmodel: {}\n")


def _milestone_steps(milestones, extra=()):
    steps = {0, 1, *extra}
    for m in milestones:
        steps |= {m - 1, m, m + 1}
    return sorted(steps)


FLAGSHIP_MILESTONES = [50000 * i for i in range(1, 13)]
SCHEDULES = {
    "flagship": ({"type": "flagship"},
                 _milestone_steps(FLAGSHIP_MILESTONES, (650000, 950000, 1301000))),
    "multistep": ({"type": "multistep", "base_lr": 0.0004,
                   "milestones": [200000, 500000, 650000], "gamma": 0.5},
                  _milestone_steps([200000, 500000, 650000])),
    "multistep_then_cosine": ({"type": "multistep_then_cosine", "base_lr": 1e-3,
                               "milestones": [10, 20], "gamma": 0.1, "switch_step": 30,
                               "cosine_base_lr": 5e-4, "cosine_t_max": 50},
                              _milestone_steps([10, 20, 30], (55, 80, 81))),
    "constant": ({"type": "constant", "base_lr": 2e-4}, [0, 1, 10 ** 6]),
    "flagship_step_offset": ({"type": "flagship", "step_offset": 49999},
                             _milestone_steps([m - 49999 for m in FLAGSHIP_MILESTONES])),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax_at_milestones(name):
    """Each schedule, step_offset included, at and beside every milestone
    (and the cosine's switch and span) equals JAX's f32 value within its
    rounding."""
    conf, steps = SCHEDULES[name]
    ours, theirs = build_schedule(dict(conf)), jax_build_schedule(dict(conf))
    got = np.array([ours(s) for s in steps])
    want = np.array([float(theirs(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    assert len(set(np.round(got, 12))) > 1 or name == "constant"


def test_schedule_functions_match_jax_directly():
    steps = [0, 49999, 50000, 599999, 600000, 600001, 1301000]
    ours, theirs = schedules.flagship_lr_schedule(), jax_schedules.flagship_lr_schedule()
    np.testing.assert_allclose([ours(s) for s in steps], [float(theirs(s)) for s in steps],
                               rtol=2e-6)
    ours = schedules.multistep_schedule(1.0, [3, 5], 0.1)
    assert [ours(s) for s in range(7)] == pytest.approx([1, 1, 1, 0.1, 0.1, 0.01, 0.01])


@pytest.mark.parametrize("parallel", [{"data_parallel": 2}, {"tensor_parallel": 2},
                                      {"data_parallel": "auto", "tensor_parallel": 4}])
def test_multi_device_training_is_refused(parallel):
    """Without a process group the run is one rank: a degree above 1 is
    refused (dp · tp must be the world size, as JAX's mesh needs that many
    devices). "auto" and 1 resolve to 1 × 1."""
    with pytest.raises(ValueError, match="needs [0-9]+ ranks; the run has 1"):
        resolve_parallel(parallel)
    assert resolve_parallel({"data_parallel": "auto"}) == resolve_parallel({}) == (1, 1)


def test_chip_smoke_train_configs_equal_the_files():
    """chip_smoke.py keeps the three training configurations itself: each
    one's manual_seed, model, parallel and train sections, and its
    datasets.train section without the two paths, equal the files."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert set(mod.TRAIN_CONFIGS) == {"flagship_sigma25", "micro_distill_sigma25",
                                      "lightformer_pixel_sigma"}
    for name, copy in mod.TRAIN_CONFIGS.items():
        with open(os.path.join(REPO, "configs", f"{name}.yaml")) as fh:
            conf = yaml.safe_load(fh)
        data = {k: v for k, v in conf["datasets"]["train"].items()
                if k not in ("csv_path", "root_folder")}
        assert copy == {"manual_seed": conf["manual_seed"], "model": conf["model"],
                        "parallel": conf["parallel"], "datasets_train": data,
                        "train": conf["train"]}, name
