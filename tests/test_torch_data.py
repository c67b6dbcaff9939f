"""The port's data feed against the JAX package's, on the CPU.

Both packages read the on-disk dataset that ``tests/synthetic.py`` builds
(both ``constants.sensorium_dir`` are pointed at it, as
``tests/test_fill_loader.py`` does). Batches must be bit-identical for the
same seed and epoch, with CutMix on, through the native host library and
through NumPy (``SENSORIUM_NATIVE=0``); fold tiers and catalogs equal; the
pHash equal to the JAX package's and to ``tests/golden/phash_golden.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from sensorium_tpu import constants as jconstants
from sensorium_tpu.data import datasets as jdatasets
from sensorium_tpu.data import loader as jloader
from sensorium_tpu.data import mixers as jmixers
from sensorium_tpu.data import mouse_data as jmouse_data
from sensorium_tpu.data import native as jnative
from sensorium_tpu.data import phash as jphash
from sensorium_tpu.data.indexes import WindowIndexer as JWindowIndexer
from sensorium_tpu.data.inputs import get_inputs_processor as jget_inputs_processor
from sensorium_tpu.data.responses import get_responses_processor as jget_responses_processor
from sensorium_tpu_torch import constants
from sensorium_tpu_torch.data import datasets, loader, mixers, mouse_data, native, phash
from sensorium_tpu_torch.data.indexes import WindowIndexer
from sensorium_tpu_torch.data.inputs import get_inputs_processor
from sensorium_tpu_torch.data.responses import ResponseNormalizer, get_responses_processor
from sensorium_tpu_torch.utils.misc import get_best_model_path, get_length_without_nan
from tests.synthetic import SYNTH_IMAGE_SIZE, build_synthetic_dataset

GOLDEN_PATH = Path(__file__).parent / "golden" / "phash_golden.json"
FRAMES, STEP = 4, 2


def repoint(root: Path) -> None:
    """Both packages' dataset root, and no cached fold tiers from another root."""
    constants.sensorium_dir = root
    jconstants.sensorium_dir = root
    mouse_data.get_folds_tiers.cache_clear()
    jmouse_data.get_folds_tiers.cache_clear()


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    build_synthetic_dataset(root, seed=5)
    old = (constants.sensorium_dir, jconstants.sensorium_dir)
    repoint(root)
    yield root
    constants.sensorium_dir, jconstants.sensorium_dir = old
    mouse_data.get_folds_tiers.cache_clear()
    jmouse_data.get_folds_tiers.cache_clear()


@pytest.fixture
def native_mode(request, monkeypatch):
    """``SENSORIUM_NATIVE`` set for both packages, their libraries reloaded."""
    monkeypatch.setenv("SENSORIUM_NATIVE", request.param)
    native.reset()
    jnative.reset()
    yield request.param
    native.reset()
    jnative.reset()


def test_constants_match_the_jax_package():
    for name in ("mice", "num_neurons", "index2mouse", "mouse2index", "mouse2num_neurons", "max_num_neurons",
                 "folds_splits", "unlabeled_splits", "num_folds", "submission_limit_length",
                 "submission_skip_first", "submission_skip_last", "new_mice", "old_mice"):
        assert getattr(constants, name) == getattr(jconstants, name), name


def test_misc_helpers(tmp_path):
    assert get_length_without_nan(np.array([1.0, 2.0, np.nan, 3.0])) == 2
    assert get_length_without_nan(np.ones(5)) == 5
    for name in ("model-001-0.100000.ckpt", "model-002-0.300000.ckpt", "model-003--0.500000.ckpt"):
        (tmp_path / name).touch()
    assert get_best_model_path(tmp_path).name == "model-002-0.300000.ckpt"
    assert get_best_model_path(tmp_path, return_score=True, more_better=False)[1] == -0.5
    assert get_best_model_path(tmp_path / "missing", return_score=True) == (None, -np.inf)


def test_phash_matches_the_jax_package_and_the_goldens():
    golden = json.loads(GOLDEN_PATH.read_text())
    for case in golden["frames"]:
        frame = np.random.default_rng(case["seed"]).uniform(0, 255, case["shape"])
        assert f"{phash.frame_phash(frame):016x}" == case["hash"]
    for case in golden["videos"]:
        video = np.random.default_rng(case["seed"]).uniform(0, 255, case["shape"])
        assert f"{phash.video_phash(video):016x}" == case["hash"]
    rng = np.random.default_rng(9)
    for shape in ((36, 64), (12, 16), (64, 64)):
        frame = rng.uniform(0, 255, shape)
        assert phash.frame_phash(frame) == jphash.frame_phash(frame)
    video = rng.uniform(0, 255, (20, 30, 40))
    video[..., 33:] = np.nan
    assert phash.video_phash(video) == jphash.video_phash(video)
    with pytest.raises(ValueError, match="usable frames"):
        phash.video_phash(video[..., :4])


@pytest.mark.parametrize("assignment", ["phash", "trial"])
def test_folds_tiers_and_catalogs_match(dataset_root, monkeypatch, assignment):
    monkeypatch.setenv("SENSORIUM_FOLD_ASSIGNMENT", assignment)
    splits = constants.folds_splits + ["live_test_main"]
    for mouse in constants.mice:
        tiers = mouse_data.get_folds_tiers(mouse, constants.num_folds)
        np.testing.assert_array_equal(tiers, jmouse_data.get_folds_tiers(mouse, jconstants.num_folds))
        assert not tiers.flags.writeable
        got, want = mouse_data.get_mouse_data(mouse, splits), jmouse_data.get_mouse_data(mouse, splits)
        assert got.keys() == want.keys()
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got[key], value)
            else:
                assert got[key] == value, key
    np.testing.assert_array_equal(mouse_data.compute_video_phashes(constants.mice[0]),
                                  jmouse_data.compute_video_phashes(constants.mice[0]))
    with pytest.raises(ValueError, match="unknown mouse"):
        mouse_data.get_mouse_data("no-such-mouse", splits)
    with pytest.raises(ValueError, match="Unknown data split"):
        mouse_data.get_mouse_data(constants.mice[0], ["fold_9"])


def test_fold_tiers_follow_the_dataset_root(dataset_root, tmp_path, monkeypatch):
    """A repointed ``sensorium_dir`` is read at the next call, not served from the cache."""
    monkeypatch.setenv("SENSORIUM_FOLD_ASSIGNMENT", "trial")
    mouse = constants.mice[0]
    before = mouse_data.get_folds_tiers(mouse, 7)
    (tmp_path / mouse / "meta" / "trials").mkdir(parents=True)
    np.save(tmp_path / mouse / "meta" / "trials" / "tiers.npy", np.array(["train"] * 3 + ["none"]))
    constants.sensorium_dir = tmp_path
    try:
        assert list(mouse_data.get_folds_tiers(mouse, 7)) == ["fold_0", "fold_1", "fold_2", "none"]
    finally:
        constants.sensorium_dir = dataset_root
    np.testing.assert_array_equal(mouse_data.get_folds_tiers(mouse, 7), before)


def catalogs(splits):
    return ([mouse_data.get_mouse_data(m, splits) for m in constants.mice],
            [jmouse_data.get_mouse_data(m, splits) for m in jconstants.mice])


def processors(port: bool):
    size = {"size": SYNTH_IMAGE_SIZE, "pad_fill_value": 0.0}
    if port:
        return WindowIndexer(FRAMES, STEP), get_inputs_processor("stack_inputs", size), get_responses_processor(
            "identity", {})
    return JWindowIndexer(FRAMES, STEP), jget_inputs_processor("stack_inputs", size), jget_responses_processor(
        "identity", {})


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.inputs, b.inputs)
        np.testing.assert_array_equal(a.targets, b.targets)
        np.testing.assert_array_equal(a.weights, b.weights)


@pytest.mark.parametrize("native_mode", ["1", "0"], indirect=True)
def test_train_batches_with_cutmix_are_bit_identical(dataset_root, native_mode, monkeypatch):
    monkeypatch.setenv("SENSORIUM_FOLD_ASSIGNMENT", "trial")
    port_data, jax_data = catalogs(["fold_1", "fold_2", "fold_3"])
    port_ds = datasets.TrainMiceDataset(port_data, *processors(True), mouse_epoch_size=4,
                                        mixer=mixers.CutMix(alpha=1.0, prob=0.5), seed=3)
    jax_ds = jdatasets.TrainMiceDataset(jax_data, *processors(False), mouse_epoch_size=4,
                                        mixer=jmixers.CutMix(alpha=1.0, prob=0.5), seed=3)
    assert native.available() == (native_mode == "1")
    port_loader = loader.MiceDataLoader(port_ds, batch_size=8, shuffle=True, seed=1, num_threads=2, drop_last=True)
    jax_loader = jloader.MiceDataLoader(jax_ds, batch_size=8, shuffle=True, seed=1, num_threads=2, drop_last=True)
    assert len(port_loader) == len(jax_loader) == 5
    for epoch in (0, 1):
        port_loader.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        assert_batches_equal(list(port_loader), list(jax_loader))
    # The allocating path (get + collate) gives the same samples as the zero-copy one.
    indexes = list(range(len(port_ds)))
    ref = datasets.collate_mice_batch([port_ds.get(i, 1) for i in indexes], port_ds.num_mice, port_ds.max_neurons)
    want = jdatasets.collate_mice_batch([jax_ds.get(i, 1) for i in indexes], jax_ds.num_mice, jax_ds.max_neurons)
    assert_batches_equal([ref], [want])


@pytest.mark.parametrize("native_mode", ["1", "0"], indirect=True)
def test_val_batches_are_bit_identical(dataset_root, native_mode, monkeypatch):
    monkeypatch.setenv("SENSORIUM_FOLD_ASSIGNMENT", "trial")
    port_data, jax_data = catalogs(["fold_0"])
    port_ds = datasets.ValMiceDataset(port_data, *processors(True))
    jax_ds = jdatasets.ValMiceDataset(jax_data, *processors(False))
    assert len(port_ds) == len(jax_ds) == 10 * (60 // 7)
    got = list(loader.MiceDataLoader(port_ds, batch_size=12, num_threads=3))
    assert_batches_equal(got, list(jloader.MiceDataLoader(jax_ds, batch_size=12, num_threads=3)))
    assert got[-1].inputs.shape[0] == len(port_ds) % 12  # no drop_last: a short last batch


def test_mixers_draw_like_the_jax_package():
    rng = np.random.default_rng(0)
    a = (rng.uniform(0, 1, (5, 4, 8, 6)).astype(np.float32), rng.uniform(0, 1, (7, 4)).astype(np.float32))
    b = (rng.uniform(0, 1, (5, 4, 8, 6)).astype(np.float32), rng.uniform(0, 1, (7, 4)).astype(np.float32))
    pairs = [
        (mixers.CutMix(1.0), jmixers.CutMix(1.0)),
        (mixers.Mixup(0.4), jmixers.Mixup(0.4)),
        (mixers.RandomChoiceMixer([mixers.CutMix(), mixers.Mixup()], [0.3, 0.7]),
         jmixers.RandomChoiceMixer([jmixers.CutMix(), jmixers.Mixup()], [0.3, 0.7])),
    ]
    for mixer, jmixer in pairs:
        for seed in range(4):
            got = mixer(a, b, np.random.default_rng(seed))
            want = jmixer(a, b, np.random.default_rng(seed))
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
            rows = (a[0].copy(), a[1].copy())
            mixer.mix_into(rows, (b[0].copy(), b[1].copy()), np.random.default_rng(seed))
            for x, y in zip(rows, want):
                np.testing.assert_array_equal(x, np.asarray(y, np.float32))


def test_response_normalizer_and_processors(dataset_root):
    from sensorium_tpu.data.responses import ResponseNormalizer as JResponseNormalizer

    responses = np.random.default_rng(1).normal(0, 1, (18, 9)).astype(np.float32)
    np.testing.assert_array_equal(ResponseNormalizer(constants.mice[0])(responses),
                                  JResponseNormalizer(jconstants.mice[0])(responses))
    for name, params in (("identity", {}), ("indexing", {"index": 3}), ("last", {})):
        np.testing.assert_array_equal(get_responses_processor(name, params)(responses),
                                      jget_responses_processor(name, params)(responses))


def test_native_kernels_match_numpy(dataset_root):
    """The C++ gathers against their NumPy paths, and a loader-size fill."""
    rng = np.random.default_rng(2)
    src = (rng.normal(0, 1, (6, 40)) - 0.2).astype(np.float32)
    idx = np.arange(3, 30, 3)
    np.testing.assert_array_equal(native.gather_rows(src, idx), src[:, idx])
    out = np.empty((6, idx.size), np.float32)
    assert native.gather_rows_relu_into(src, idx, out)
    np.testing.assert_array_equal(out, np.maximum(src[:, idx], 0.0))
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([0, 40]))
    video = rng.uniform(0, 255, (12, 14, 40)).astype(np.float32)
    sig = rng.uniform(0, 5, (2, 40)).astype(np.float32)
    got = native.assemble_stack_input(video, sig, sig * 2, idx, (16, 16), fill=-1.0)
    np.testing.assert_array_equal(got, get_inputs_processor("stack_inputs", {"size": (16, 16), "pad_fill_value": -1.0})(
        video[..., idx], sig[:, idx], (sig * 2)[:, idx]))
    fill = native.make_trial_filler(video, sig, sig, src, (16, 16))
    with pytest.raises(IndexError, match="out of range"):
        fill(np.array([39, 40]), 0.0, np.empty((5, 2, 16, 16), np.float32), np.empty((6, 2), np.float32))


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_host")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setenv("SENSORIUM_NATIVE", "1")
    native.reset()
    try:
        with pytest.raises(RuntimeError, match="native host library build failed"):
            native.available()
    finally:
        native.reset()


def test_datasets_refuse_misordered_mice_and_short_trials(dataset_root, monkeypatch):
    monkeypatch.setenv("SENSORIUM_FOLD_ASSIGNMENT", "trial")
    data, _ = catalogs(["fold_0"])
    with pytest.raises(ValueError, match="canonical"):
        datasets.ValMiceDataset(data[::-1], *processors(True))
    with pytest.raises(ValueError, match="no trial of at least"):
        datasets.TrainMiceDataset(data, WindowIndexer(40, 2), *processors(True)[1:], mouse_epoch_size=1)


def test_resolve_workers(monkeypatch):
    monkeypatch.delenv("SENSORIUM_LOADER_THREADS", raising=False)
    assert 1 <= loader.resolve_workers(64) <= 64
    assert loader.resolve_workers(64) == jloader.resolve_workers(64)
    monkeypatch.setenv("SENSORIUM_LOADER_THREADS", "3")
    assert loader.resolve_workers(1) == 3
    monkeypatch.setenv("SENSORIUM_LOADER_THREADS", "many")
    with pytest.raises(ValueError, match="integer"):
        loader.resolve_workers(1)
