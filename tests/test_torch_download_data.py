"""The port's download CLI (``sensorium_tpu_torch/cli/download_data.py``), network mocked.

The cases of ``tests/test_download_data.py``: a mouse's zip fetched,
extracted and removed, a rerun that skips the download; the old mice's
back-fill skipped without deeplake; the released responses written from a
fake deeplake; a skipped back-fill repaired on rerun. Nothing here reaches
the network.
"""

from __future__ import annotations

import builtins
import io
import sys
import types
import zipfile

import numpy as np

from sensorium_tpu import constants as jconstants
from sensorium_tpu_torch import constants
from sensorium_tpu_torch.cli import download_data as dl


def make_zip_bytes(mouse: str) -> bytes:
    buffer = io.BytesIO()
    with zipfile.ZipFile(buffer, "w") as zf:
        zf.writestr(f"{mouse}/meta/trials/tiers.npy", b"fake")
        zf.writestr("__MACOSX/junk", b"")
    return buffer.getvalue()


def test_urls_and_datasets_are_the_jax_packages():
    assert constants.mouse2dataset == jconstants.mouse2dataset
    assert constants.dataset2url_format == jconstants.dataset2url_format


def test_download_mouse_extracts_and_cleans_up(tmp_path, monkeypatch):
    mouse = constants.new_mice[0]
    urls = []

    def fake_download(url, dest):
        urls.append(url)
        dest.write_bytes(make_zip_bytes(mouse))

    monkeypatch.setattr(dl, "download_file", fake_download)
    dl.download_mouse(mouse, tmp_path)

    assert urls == [constants.dataset2url_format["new"].format(file_name=f"{mouse}.zip")]
    assert (tmp_path / mouse / "meta" / "trials" / "tiers.npy").exists()
    assert not (tmp_path / f"{mouse}.zip").exists()
    assert not (tmp_path / "__MACOSX").exists()
    assert not (tmp_path / f".{mouse}.extracting").exists()

    dl.download_mouse(mouse, tmp_path)  # the mouse is there: no download
    assert len(urls) == 1


def test_incomplete_mouse_is_downloaded_again(tmp_path, monkeypatch):
    mouse = constants.new_mice[1]
    (tmp_path / mouse / "data").mkdir(parents=True)  # an extract cut short: no tiers.npy
    monkeypatch.setattr(dl, "download_file", lambda url, dest: dest.write_bytes(make_zip_bytes(mouse)))
    dl.download_mouse(mouse, tmp_path)
    assert (tmp_path / mouse / "meta" / "trials" / "tiers.npy").exists()
    assert not (tmp_path / mouse / "data").exists()


def test_old_mouse_backfill_skips_without_deeplake(tmp_path, monkeypatch, capsys):
    mouse = constants.old_mice[0]
    monkeypatch.setattr(dl, "download_file", lambda url, dest: dest.write_bytes(make_zip_bytes(mouse)))
    real_import = builtins.__import__

    def no_deeplake(name, *args, **kwargs):
        if name == "deeplake":
            raise ImportError("mocked out")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_deeplake)
    dl.download_mouse(mouse, tmp_path)  # must not raise
    assert "skipping response back-fill" in capsys.readouterr().out


def test_backfill_writes_released_responses(tmp_path, monkeypatch):
    mouse = constants.old_mice[1]
    (tmp_path / mouse / "data" / "responses").mkdir(parents=True)

    class FakeColumn:
        def __init__(self, arrays):
            self._arrays = arrays

        def numpy(self):
            return np.asarray(self._arrays)

        def __getitem__(self, index):
            return FakeColumn(self._arrays[index])

    class FakeDataset:
        def __init__(self, trial_ids, responses):
            self.id = FakeColumn(np.asarray(trial_ids, dtype=np.int64)[:, None])
            self.responses = FakeColumn(responses)

    responses = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    loaded = []
    fake_module = types.ModuleType("deeplake")
    fake_module.load = lambda path: loaded.append(path) or FakeDataset([7, 9], responses)
    monkeypatch.setitem(sys.modules, "deeplake", fake_module)

    dl.backfill_old_mouse_responses(mouse, tmp_path / mouse)
    assert loaded == [f"hub://sinzlab/Sensorium_2023_{mouse}_{split}" for split in constants.unlabeled_splits]
    for i, trial_id in enumerate((7, 9)):
        saved = np.load(tmp_path / mouse / "data" / "responses" / f"{trial_id}.npy")
        np.testing.assert_array_equal(saved, responses[i])


def test_rerun_repairs_skipped_backfill(tmp_path, monkeypatch):
    mouse = constants.old_mice[0]
    mouse_dir = tmp_path / mouse
    (mouse_dir / "data" / "responses").mkdir(parents=True)
    (mouse_dir / "meta" / "trials").mkdir(parents=True)
    # Trial 0 labeled, trial 1 of an unlabeled split whose responses were never back-filled.
    np.save(mouse_dir / "meta" / "trials" / "tiers.npy", np.array(["train", constants.unlabeled_splits[0]]))
    np.save(mouse_dir / "data" / "responses" / "0.npy", np.zeros(3, np.float32))
    assert dl.missing_backfill_trials(mouse_dir) == [1]

    calls = []
    monkeypatch.setattr(dl, "backfill_old_mouse_responses", lambda m, d: calls.append((m, d)))
    monkeypatch.setattr(dl, "download_file", lambda url, dest: (_ for _ in ()).throw(AssertionError))
    dl.download_mouse(mouse, tmp_path)  # the directory is there: no download, but the repair
    assert calls == [(mouse, mouse_dir)]

    np.save(mouse_dir / "data" / "responses" / "1.npy", np.zeros(3, np.float32))
    assert dl.missing_backfill_trials(mouse_dir) == []
    calls.clear()
    dl.download_mouse(mouse, tmp_path)
    assert calls == []


def test_main_downloads_every_mouse_under_the_path(tmp_path, monkeypatch):
    monkeypatch.setattr(dl, "download_mouse", lambda mouse, root: fetched.append((mouse, root)))
    fetched = []
    dl.main(["-p", str(tmp_path / "sensorium")])
    assert fetched == [(mouse, tmp_path / "sensorium") for mouse in constants.mice]
    assert (tmp_path / "sensorium").is_dir()
