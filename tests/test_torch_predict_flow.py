"""The port's prediction flow against the JAX package's, on the CPU.

Over ``tests/synthetic.py``'s dataset (folds by trial index), with seven
fold checkpoints written by the JAX package: ``Predictor`` built from a
checkpoint, ``predict_mouse_split`` with one, two and seven predictors
(shared staging, and unequal signatures that blend on the host), the
out-of-fold evaluation, the submission file, ensembles and the two CLIs.
Predictions are held at ``tests/test_torch_predictor.py``'s tolerance;
what the host computes from the same saved predictions is held equal.
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest

from sensorium_tpu import constants as jconstants
from sensorium_tpu.cli import predict as jpredict
from sensorium_tpu.data import mouse_data as jmouse_data
from sensorium_tpu.engine.checkpoint import save_model_checkpoint as jax_save_model_checkpoint
from sensorium_tpu.engine.model import MouseModel as JaxMouseModel
from sensorium_tpu.infer import ensemble as jensemble
from sensorium_tpu.infer import submission as jsubmission
from sensorium_tpu.infer.predictor import Predictor as JaxPredictor
from sensorium_tpu.infer.predictor import predict_mouse_split as jax_predict_mouse_split
from sensorium_tpu_torch import constants
from sensorium_tpu_torch.cli import ensemble as cli_ensemble
from sensorium_tpu_torch.cli import predict as cli_predict
from sensorium_tpu_torch.data import mouse_data
from sensorium_tpu_torch.infer import ensemble, submission
from sensorium_tpu_torch.infer.predictor import Predictor, predict_mouse_split
from tests.synthetic import build_synthetic_dataset, tiny_experiment_config

RTOL = ATOL = 1e-4  # tests/test_torch_predictor.py
EXPERIMENT = "flow"
SPLIT = "live_test_main"
CHUNK = 8
DIRS = ("sensorium_dir", "experiments_dir", "predictions_dir")


def fold_params(pad_fill_value: float = 0.0) -> dict:
    params = tiny_experiment_config()["argus_params"]
    name, processor = params["inputs_processor"]
    return {**params, "inputs_processor": (name, {**processor, "pad_fill_value": pad_fill_value})}


def fold_variables(base: dict, fold: int) -> dict:
    """Fold ``fold``'s weights: the base kernels, BN statistics and biases drawn."""
    rng = np.random.default_rng(100 + fold)

    def draw(path, leaf):
        name, leaf = path[-1].key, np.asarray(leaf)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name in ("mean", "bias", "readout_bias"):
            return rng.normal(0, 0.3, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, base)


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """The dataset, seven JAX-written fold checkpoints of ``EXPERIMENT`` (and
    of ``EXPERIMENT``-fill, with another pad fill value), and the packages'
    directories pointed at them; the JAX package predicts into its own."""
    root = tmp_path_factory.mktemp("predict_flow")
    build_synthetic_dataset(root / "data", seed=3, test_trials=2)
    saved = {name: (getattr(constants, name), getattr(jconstants, name)) for name in DIRS}
    for name, path in zip(DIRS, (root / "data", root / "experiments", root / "port_predictions")):
        setattr(constants, name, path)
        setattr(jconstants, name, path if name != "predictions_dir" else root / "jax_predictions")
    old_assignment = os.environ.get("SENSORIUM_FOLD_ASSIGNMENT")
    os.environ["SENSORIUM_FOLD_ASSIGNMENT"] = "trial"
    mouse_data.get_folds_tiers.cache_clear()
    jmouse_data.get_folds_tiers.cache_clear()

    model = JaxMouseModel(fold_params())
    model.build_state(seed=0, learning_rate=0.0)
    base = jax.device_get(model.eval_variables())
    for experiment, fill in ((EXPERIMENT, 0.0), (f"{EXPERIMENT}-fill", 1.0)):
        for fold in range(constants.num_folds):
            fold_dir = root / "experiments" / experiment / f"fold_{fold}"
            fold_dir.mkdir(parents=True)
            jax_save_model_checkpoint(fold_dir / f"model-004-0.{fold}00000.ckpt", fold_params(fill),
                                      fold_variables(base, fold))
    yield root

    for name, (port_value, jax_value) in saved.items():
        setattr(constants, name, port_value)
        setattr(jconstants, name, jax_value)
    if old_assignment is None:
        os.environ.pop("SENSORIUM_FOLD_ASSIGNMENT")
    else:
        os.environ["SENSORIUM_FOLD_ASSIGNMENT"] = old_assignment
    mouse_data.get_folds_tiers.cache_clear()
    jmouse_data.get_folds_tiers.cache_clear()


def fold_checkpoint(root, fold: int, experiment: str = EXPERIMENT):
    return next((root / "experiments" / experiment / f"fold_{fold}").glob("*.ckpt"))


def assert_same_predictions(port_dir, jax_dir, exact: bool = False) -> int:
    files = sorted(p.name for p in jax_dir.glob("*.npy"))
    assert files and files == sorted(p.name for p in port_dir.glob("*.npy"))
    for name in files:
        got, expected = np.load(port_dir / name), np.load(jax_dir / name)
        assert got.dtype == expected.dtype == np.float32 and got.shape == expected.shape, name
        if exact:
            np.testing.assert_array_equal(got, expected, err_msg=name)
        else:
            np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL, err_msg=name)
    return len(files)


def test_predictor_from_a_checkpoint_matches_jax(flow):
    path = fold_checkpoint(flow, 2)
    rng = np.random.default_rng(7)
    video = rng.uniform(0, 255, (12, 16, 41)).astype(np.float32)
    behavior = rng.uniform(0, 5, (2, 41)).astype(np.float32)
    pupil = rng.uniform(50, 200, (2, 41)).astype(np.float32)
    got = Predictor(path, chunk_size=CHUNK, device="cpu").predict_trial(video, behavior, pupil, mouse_index=3)
    expected = JaxPredictor(path, chunk_size=CHUNK).predict_trial(video, behavior, pupil, mouse_index=3)
    assert got.shape == expected.shape == (21, 41)
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["one", "two_shared", "seven_shared", "two_unequal"])
def test_predict_mouse_split_matches_jax(flow, case, monkeypatch):
    folds = {"one": [0], "two_shared": [0, 1], "seven_shared": list(range(7)), "two_unequal": [0, 1]}[case]
    experiments = [EXPERIMENT, f"{EXPERIMENT}-fill"] if case == "two_unequal" else [EXPERIMENT] * len(folds)
    paths = [fold_checkpoint(flow, fold, exp) for fold, exp in zip(folds, experiments)]
    predictors = [Predictor(path, chunk_size=CHUNK, device="cpu") for path in paths]
    shared = case != "two_unequal"
    assert (predictors[0].stage_signature() == predictors[-1].stage_signature()) == shared

    staged = []
    stage_trial = Predictor.stage_trial
    monkeypatch.setattr(Predictor, "stage_trial", lambda self, *a: staged.append(1) or stage_trial(self, *a))
    mouse = constants.new_mice[1]
    port_dir, jax_dir = flow / "split" / case / "port", flow / "split" / case / "jax"
    predict_mouse_split(mouse, SPLIT, predictors, port_dir)
    jax_predict_mouse_split(mouse, SPLIT, [JaxPredictor(path, chunk_size=CHUNK) for path in paths], jax_dir)
    trials = assert_same_predictions(port_dir, jax_dir)
    assert trials == 2
    assert len(staged) == trials * (1 if shared else len(predictors))


def test_predict_mouse_split_takes_a_trial_shard(flow):
    predictor = Predictor(fold_checkpoint(flow, 0), chunk_size=CHUNK, device="cpu")
    mouse = constants.new_mice[0]
    whole, shards = flow / "shard" / "whole", flow / "shard" / "parts"
    predict_mouse_split(mouse, SPLIT, [predictor], whole)
    for index in range(2):
        predict_mouse_split(mouse, SPLIT, [predictor], shards, trial_shard=(index, 2))
    assert assert_same_predictions(shards, whole, exact=True) == 2


@pytest.fixture(scope="module")
def folds_predicted(flow):
    """Out-of-fold predictions of both packages' CLIs (new mice)."""
    cli_predict.main(["-e", EXPERIMENT, "-s", "folds", "--device", "cpu", "--chunk-size", str(CHUNK)])
    jpredict.predict_folds(EXPERIMENT, "new", chunk_size=CHUNK)
    jsubmission.evaluate_folds_predictions(EXPERIMENT, "new")
    return flow


def test_cli_predict_folds_matches_jax(folds_predicted):
    port_oof = constants.predictions_dir / EXPERIMENT / "out-of-fold"
    jax_oof = jconstants.predictions_dir / EXPERIMENT / "out-of-fold"
    for mouse in constants.new_mice:
        assert assert_same_predictions(port_oof / mouse, jax_oof / mouse) == 7
    got = json.loads((port_oof / "evaluate_new.json").read_text())
    expected = json.loads((jax_oof / "evaluate_new.json").read_text())
    assert got.keys() == expected.keys() and got["correlations"].keys() == expected["correlations"].keys()
    np.testing.assert_allclose(got["mean_correlation"], expected["mean_correlation"], rtol=1e-4, atol=1e-5)


def test_evaluate_folds_predictions_json_equal(folds_predicted, tmp_path):
    """From the same saved predictions, the same JSON, byte for byte."""
    copy = "evaluated"
    shutil.copytree(jconstants.predictions_dir / EXPERIMENT, constants.predictions_dir / copy)
    (constants.predictions_dir / copy / "out-of-fold" / "evaluate_new.json").unlink()
    result = submission.evaluate_folds_predictions(copy, "new")
    expected_path = jconstants.predictions_dir / EXPERIMENT / "out-of-fold" / "evaluate_new.json"
    assert (constants.predictions_dir / copy / "out-of-fold" / "evaluate_new.json").read_text() == \
        expected_path.read_text()
    assert result == json.loads(expected_path.read_text())


@pytest.fixture(scope="module")
def unlabeled_predicted(flow):
    """The port's CLI on the unlabeled split: 7 fold models, then the submission."""
    cli_predict.main(["-e", EXPERIMENT, "-s", SPLIT, "--device", "cpu", "--chunk-size", str(CHUNK)])
    jpredict.predict_unlabeled_split(EXPERIMENT, SPLIT, "new", chunk_size=CHUNK)
    return flow


def test_cli_predict_unlabeled_split_matches_jax(unlabeled_predicted):
    for mouse in constants.new_mice:
        assert assert_same_predictions(constants.predictions_dir / EXPERIMENT / SPLIT / mouse,
                                       jconstants.predictions_dir / EXPERIMENT / SPLIT / mouse) == 2
    assert (constants.predictions_dir / EXPERIMENT / SPLIT / "predictions_live_main.parquet.brotli").exists()


def test_make_submission_parquet_matches_jax(unlabeled_predicted):
    """From the same saved predictions, the same parquet, field by field and byte for byte."""
    copy = "submitted"
    shutil.copytree(jconstants.predictions_dir / EXPERIMENT / SPLIT, constants.predictions_dir / copy / SPLIT)
    submission.make_submission(copy, SPLIT)
    jsubmission.make_submission(EXPERIMENT, SPLIT)
    name = f"predictions_{submission.submission_split_name(SPLIT)}.parquet.brotli"
    got_path = constants.predictions_dir / copy / SPLIT / name
    expected_path = jconstants.predictions_dir / EXPERIMENT / SPLIT / name
    got, expected = pd.read_parquet(got_path), pd.read_parquet(expected_path)
    assert list(got.columns) == list(expected.columns) == ["mouse", "trial_indices", "prediction", "neuron_ids"]
    assert len(got) == len(expected) == 10
    for column in got.columns:
        for a, b in zip(got[column], expected[column]):
            if column == "prediction":
                assert len(a) == len(b)
                for row_a, row_b in zip(a, b):
                    np.testing.assert_array_equal(row_a, row_b)
            else:
                np.testing.assert_array_equal(a, b)
    assert got_path.read_bytes() == expected_path.read_bytes()


def test_submission_cut_and_split_names():
    prediction = np.arange(3 * 320, dtype=np.float32).reshape(3, 320)
    np.testing.assert_array_equal(submission.submission_cut(prediction), jsubmission.submission_cut(prediction))
    assert submission.submission_cut(prediction).shape == (3, 249)
    assert submission.cut_responses_for_submission is submission.submission_cut
    for split in constants.unlabeled_splits:
        assert submission.submission_split_name(split) == jsubmission.submission_split_name(split)


def test_ensemble_matches_jax(unlabeled_predicted):
    """Two experiments' saved predictions averaged by both packages: equal bit for bit."""
    source = jconstants.predictions_dir / EXPERIMENT / SPLIT
    for name, scale in (("ens_a", 1.0), ("ens_b", 3.0)):
        for mouse_dir in (p for p in source.iterdir() if p.is_dir()):
            for root in (constants.predictions_dir, jconstants.predictions_dir):
                (root / name / SPLIT / mouse_dir.name).mkdir(parents=True, exist_ok=True)
                for f in mouse_dir.glob("*.npy"):
                    np.save(root / name / SPLIT / mouse_dir.name / f.name, np.load(f) * np.float32(scale))
    got = ensemble.ensemble_experiments(["ens_a", "ens_b"], SPLIT, "new")
    expected = jensemble.ensemble_experiments(["ens_a", "ens_b"], SPLIT, "new")
    assert got == expected == "ens_a,ens_b"
    for mouse in constants.new_mice:
        assert assert_same_predictions(constants.predictions_dir / got / SPLIT / mouse,
                                       jconstants.predictions_dir / got / SPLIT / mouse, exact=True) == 2


def test_cli_ensemble_end_to_end(folds_predicted, capsys):
    source = constants.predictions_dir / EXPERIMENT / "out-of-fold"
    shutil.copytree(source, constants.predictions_dir / "twin" / "out-of-fold")
    cli_ensemble.main(["-e", f"twin,{EXPERIMENT}", "-s", "folds"])
    name = f"{EXPERIMENT},twin"
    for mouse in constants.new_mice:
        assert assert_same_predictions(constants.predictions_dir / name / "out-of-fold" / mouse,
                                       source / mouse, exact=True) == 7
    ensembled = json.loads((constants.predictions_dir / name / "out-of-fold" / "evaluate_new.json").read_text())
    assert ensembled == json.loads((source / "evaluate_new.json").read_text())
    with pytest.raises(SystemExit, match="at least two"):
        cli_ensemble.main(["-e", EXPERIMENT, "-s", "folds"])


def test_cli_predict_refuses_what_waits_for_multi_gpu():
    """``--mesh`` and ``--multihost`` are ported; what the JAX CLI refuses
    with them is refused: ``--mesh`` with ``--device`` or ``--multihost``."""
    for flags in (["--mesh", "--device", "cpu"], ["--mesh", "--multihost=auto"]):
        with pytest.raises(SystemExit):
            cli_predict.parse_arguments(["-e", EXPERIMENT, "-s", SPLIT, *flags])
    args = cli_predict.parse_arguments(["-e", EXPERIMENT, "-s", SPLIT, "--mesh"])
    assert args.mesh and args.device is None and args.multihost is None
