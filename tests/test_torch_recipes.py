"""The recipes of ``cli/recipes.py`` (what ``chip_smoke.py`` and the card
runs train from) against the repo's YAML recipes after ``load_config``:
equal but for the data directory.  And the runner's handling of a config
dict: overrides merged on top, the dict left as it was, and the
``config.yaml`` a run writes read back to the config it ran."""

import json

import pytest

from audiocaption_tpu_torch.cli import recipes
from audiocaption_tpu_torch.utils import config as C

PAIRS = {
    "synthetic_v2/effb2_trm.yaml": ("flagship_train", "data/synthetic_v2"),
    "synthetic_v2/test.yaml": ("flagship_test", "data/synthetic_v2"),
    "synthetic_temporal/sed.yaml": ("sed_train", "data/synthetic_temporal"),
    "synthetic_temporal/tempgru.yaml": ("tempgru_train",
                                        "data/synthetic_temporal"),
    "synthetic_temporal/test.yaml": ("temporal_test",
                                     "data/synthetic_temporal"),
}


def _strings(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _strings(v)
    elif isinstance(node, list):
        for v in node:
            yield from _strings(v)
    elif isinstance(node, str):
        yield node


@pytest.mark.parametrize("yaml_name", list(PAIRS))
def test_recipe_dict_equals_yaml(yaml_name):
    fn, data_dir = PAIRS[yaml_name]
    want = C.load_config(f"configs/{yaml_name}")
    assert getattr(recipes, fn)(data_dir) == want
    # only the data directory differs for another one
    moved = getattr(recipes, fn)("/elsewhere/corpus")
    text = json.dumps(want).replace(data_dir + "/", "/elsewhere/corpus/")
    assert moved == json.loads(text)
    assert any(s.startswith("/elsewhere/corpus/") for s in _strings(moved))


def test_config_dict_through_the_runner(tmp_path):
    from audiocaption_tpu_torch.cli.run import Runner
    cfg = recipes.flagship_train("corpus")
    got = C.resolve_config(cfg, ["trainer.epochs=2", "device=cpu",
                                 "lr_scheduler.args.final_lrs=5.0e-5",
                                 f"experiment_path={tmp_path}/exp"])
    assert got["trainer"]["epochs"] == 2 and got["device"] == "cpu"
    assert got["lr_scheduler"]["args"]["final_lrs"] == 5e-5
    assert cfg["trainer"]["epochs"] == 25          # the dict is not edited
    ran, _, seed, exp_dir, _ = Runner()._start(
        cfg, ["trainer.epochs=2", "device=cpu",
              f"experiment_path={tmp_path}/exp"])
    assert exp_dir == tmp_path / "exp" / f"seed_{seed}"
    assert C.load_config(str(exp_dir / "config.yaml")) == ran
