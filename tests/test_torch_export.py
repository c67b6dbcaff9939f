"""The port's serving export (``infer/export.py``, ``cli/export.py``) against
the JAX package's, on the CPU.

Counterpart of ``tests/test_export.py``, at its sizes. One tiny model is
built and saved by the JAX engine, with its BN statistics and biases drawn
from numpy so that they matter; the port reads that checkpoint with its own
``load_model``. The port's artifacts are held to the port's live model and
``Predictor`` (the window forward at rtol 2e-5 / atol 1e-6, the trial
program at rtol 3e-5 / atol 1e-4: its chunks hold other windows, so the
forwards run at other batch compositions) and to the JAX package's live
model and ``.stablehlo`` artifacts on the same weights (rtol 1e-4 / atol
1e-5 for the forward, as ``tests/test_torch_model.py``; 1e-4 / 1e-4 for the
trial, as ``tests/test_torch_predictor.py``). The multi-device trial
artifacts of a data mesh (4 replicas) and a hybrid mesh (4 replicas of 2
devices) are held to the unsharded port ``Predictor`` and the JAX
package's mesh artifacts at the trial's rtol 3e-5 / atol 1e-4. Also: the
``sensorium::`` custom ops' CPU and fake implementations, the
``mesh_data`` refusals, and processes that load and run an artifact
without the port's model, engine or configs.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sensorium_tpu.engine.model import MouseModel as JaxMouseModel
from sensorium_tpu.infer import export as jexport
from sensorium_tpu.infer.predictor import Predictor as JaxPredictor
from sensorium_tpu.parallel import mesh as jax_mesh
from sensorium_tpu_torch.cli import export as export_cli
from sensorium_tpu_torch.engine.model import load_model
from sensorium_tpu_torch.infer.export import (
    EXPORT_SUFFIX,
    check_artifact,
    export_forward,
    export_model_file,
    export_trial,
    load_exported,
    save_exported,
)
from sensorium_tpu_torch.infer.predictor import Predictor
from sensorium_tpu_torch.ops import bn_kernels, dw_kernels
from sensorium_tpu_torch.parallel import mesh as mesh_lib
from tests.test_engine import tiny_params

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-5, 1e-6  # artifact against the port's live model
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5  # the port against the JAX package (tests/test_torch_model.py)
TRIAL_RTOL, TRIAL_ATOL = 3e-5, 1e-4  # trial artifact against the port's live Predictor
JAX_TRIAL_TOL = 1e-4  # tests/test_torch_predictor.py
CHUNK, BUCKET = 8, 16
SRC_HW = (12, 16)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_model(params: dict) -> JaxMouseModel:
    """A JAX model with EMA whose eval BN statistics and biases are drawn."""
    model = JaxMouseModel(params)
    model.set_ema(0.9)
    model.build_state(seed=0, learning_rate=1e-3)
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        name, leaf = path[-1].key, np.asarray(leaf)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name in ("mean", "bias", "readout_bias"):
            return rng.normal(0, 0.3, leaf.shape).astype(np.float32)
        return leaf

    state = model.state
    model.state = state.replace(
        ema_params=jax.tree_util.tree_map_with_path(perturb, jax.device_get(state.ema_params)),
        ema_batch_stats=jax.tree_util.tree_map_with_path(perturb, jax.device_get(state.ema_batch_stats)),
    )
    return model


@pytest.fixture(scope="module")
def jmodel():
    return jax_model(tiny_params())


@pytest.fixture(scope="module")
def ckpt_path(jmodel, tmp_path_factory):
    """The JAX-written checkpoint of ``jmodel``'s eval weights."""
    path = tmp_path_factory.mktemp("export") / "model-001-0.100000.ckpt"
    jmodel.save(path)
    return path


@pytest.fixture(scope="module")
def model(ckpt_path):
    return load_model(ckpt_path, device="cpu")


def _inputs(batch, size=(16, 16)):
    rng = np.random.default_rng(batch)
    return rng.uniform(0, 255, (batch, 5, 4, *size)).astype(np.float32)


def _saved_and_loaded(exported, path):
    return load_exported(save_exported(path, exported), device="cpu")


def _run(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


class TestExportForward:
    @pytest.fixture(scope="class")
    def exported0(self, model):
        return export_forward(model, mouse_index=0, platforms=("cpu",))

    @pytest.fixture(scope="class")
    def mouse0(self, exported0, tmp_path_factory):
        return _saved_and_loaded(exported0, tmp_path_factory.mktemp("m0") / "m0.pt2")

    def test_single_mouse_artifact_matches_live_models(self, model, jmodel, tmp_path):
        artifact = _saved_and_loaded(export_forward(model, mouse_index=1, platforms=("cpu",)), tmp_path / "m1.pt2")
        x = _inputs(2)
        got = _run(artifact, x)
        assert got.shape == (2, 7, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, model.predict(x, mouse_index=1).numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(jmodel.predict(x, mouse_index=1)), rtol=JAX_RTOL, atol=JAX_ATOL)
        stablehlo = jexport.load_exported(jexport.save_exported(
            tmp_path / "m1.stablehlo", jexport.export_forward(jmodel, mouse_index=1, platforms=("cpu",))))
        np.testing.assert_allclose(got, np.asarray(stablehlo.call(x)), rtol=JAX_RTOL, atol=JAX_ATOL)

    def test_bf16_model_artifact_matches_live_model(self, tmp_path):
        params = tiny_params()
        params["nn_module"][1]["dtype"] = "bfloat16"
        path = tmp_path / "model-000-0.000000.ckpt"
        jax_model(params).save(path)
        bf16 = load_model(path, device="cpu")
        artifact = _saved_and_loaded(export_forward(bf16, mouse_index=0, platforms=("cpu",)), tmp_path / "bf16.pt2")
        x = _inputs(2)
        np.testing.assert_allclose(_run(artifact, x), bf16.predict(x, mouse_index=0).numpy(), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("batch", [1, 2, 5])
    def test_symbolic_batch_serves_multiple_sizes(self, model, mouse0, batch):
        x = _inputs(batch)
        out = _run(mouse0, x)
        assert out.shape == (batch, 5, 4)
        np.testing.assert_allclose(out, model.predict(x, mouse_index=0).numpy(), rtol=RTOL, atol=ATOL)

    def test_batch_is_symbolic_in_the_program(self, exported0):
        (spec,) = [node.meta["val"] for node in exported0.program.graph.nodes
                   if node.op == "placeholder" and node.target in exported0.program.graph_signature.user_inputs]
        assert isinstance(spec.shape[0], torch.SymInt)
        assert [int(d) for d in spec.shape[1:]] == [5, 4, 16, 16]

    def test_non_square_canvas_spec_matches_live_models(self, tmp_path):
        # StackInputsProcessor.size is (width, height): the spec is (b, C, T, H, W).
        params = tiny_params()
        params["inputs_processor"] = ("stack_inputs", {"size": (12, 16), "pad_fill_value": 0.0})
        jm = jax_model(params)
        path = tmp_path / "model-000-0.000000.ckpt"
        jm.save(path)
        summary = export_model_file(path, tmp_path / "ns.pt2", mouse_index=1, platforms=("cpu",), device="cpu")
        assert summary["input_shapes"][0][1:] == ["5", "4", "16", "12"]
        assert not summary["input_shapes"][0][0].isdigit()
        x = _inputs(2, size=(16, 12))
        got = _run(load_exported(summary["artifact"], device="cpu"), x)
        live = load_model(path, device="cpu").predict(x, mouse_index=1).numpy()
        np.testing.assert_allclose(got, live, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(jm.predict(x, mouse_index=1)), rtol=JAX_RTOL, atol=JAX_ATOL)

    def test_all_mice_artifact(self, model, jmodel, tmp_path):
        artifact = _saved_and_loaded(export_forward(model, platforms=("cpu",)), tmp_path / "all.pt2")
        x = _inputs(2)
        got = _run(artifact, x)
        assert got.shape == (2, 2, 7, 4)  # (M, b, N_max, T)
        np.testing.assert_allclose(got, model.predict(x).numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(jmodel.predict(x)), rtol=JAX_RTOL, atol=JAX_ATOL)

    def test_artifact_calls_the_custom_ops(self, exported0):
        targets = [node.target for node in exported0.program.graph.nodes]
        blocks = len(tiny_params()["nn_module"][1]["core_features"])
        # Each block's pw_bn and spatial_bn run inside its depthwise convs.
        assert targets.count(torch.ops.sensorium.dw_spatial_fwd_bn.default) == blocks
        assert targets.count(torch.ops.sensorium.dw_temporal_fwd_bn.default) == blocks
        assert targets.count(torch.ops.sensorium.dw_spatial_fwd.default) == 0
        assert targets.count(torch.ops.sensorium.dw_temporal_fwd.default) == 0

    def test_platforms_other_than_cuda_and_cpu_raise(self, model):
        with pytest.raises(ValueError, match="platforms"):
            export_forward(model, mouse_index=0, platforms=("tpu", "cpu"))

    def test_loading_on_a_device_outside_the_platforms_raises(self, model, tmp_path):
        path = save_exported(tmp_path / "cuda_only.pt2", export_forward(model, mouse_index=0, platforms=("cuda",)))
        with pytest.raises(ValueError, match="runs on"):
            load_exported(path, device="cpu")


class TestExportModelFile:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_checkpoint_to_artifact_roundtrip(self, ckpt_path, model, tmp_path, writer):
        path = ckpt_path
        if writer == "port":
            path = tmp_path / "model-002-0.200000.ckpt"
            model.save(path)
        summary = export_model_file(path, mouse_index=1, platforms=("cpu",), device="cpu")
        assert summary["artifact"] == str(path.with_suffix(".mouse1" + EXPORT_SUFFIX))
        assert summary["platforms"] == ["cpu"]
        assert summary["bytes"] == Path(summary["artifact"]).stat().st_size > 0
        assert summary["nr_devices"] == 1 and summary["trial"] is False
        check = check_artifact(summary["artifact"], batch=2, device="cpu")
        assert check["finite"]
        assert check["output_shape"] == [2, 7, 4]
        assert check["min"] > 0.0  # softplus outputs are strictly positive
        x = _inputs(2)
        np.testing.assert_allclose(_run(load_exported(summary["artifact"], device="cpu"), x),
                                   load_model(path, device="cpu").predict(x, mouse_index=1).numpy(),
                                   rtol=RTOL, atol=ATOL)

    def test_cli_main(self, ckpt_path, tmp_path, capsys):
        out = tmp_path / "artifact.pt2"
        export_cli.main(["-m", str(ckpt_path), "-o", str(out), "--mouse", "0", "--device", "cpu", "--check"])
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["artifact"] == str(out) and out.exists()
        assert summary["platforms"] == ["cuda", "cpu"]
        assert summary["check"]["finite"] and summary["check"]["output_shape"] == [1, 5, 4]

    def test_cli_rejects_bad_mouse(self, ckpt_path):
        with pytest.raises(SystemExit, match="integer"):
            export_cli.main(["-m", str(ckpt_path), "--mouse", "one"])

    def test_cli_defaults_to_the_card(self):
        assert export_cli.parse_arguments(["-m", "x.ckpt"]).device == "cuda"


def _trial_arrays(length, src_hw=SRC_HW, seed=0):
    rng = np.random.default_rng(seed)
    video = rng.uniform(0, 255, (*src_hw, length)).astype(np.float32)
    behavior = rng.uniform(0, 10, (2, length)).astype(np.float32)
    pupil_center = rng.uniform(0, 10, (2, length)).astype(np.float32)
    return video, behavior, pupil_center


def _padded_args(video, behavior, pupil_center, length):
    tpad = -(-length // BUCKET) * BUCKET - length
    planes = np.ascontiguousarray(np.transpose(video, (2, 0, 1)))
    return (np.pad(planes, ((0, tpad), (0, 0), (0, 0))), np.pad(behavior, ((0, 0), (0, tpad))),
            np.pad(pupil_center, ((0, 0), (0, tpad))), np.int32(length))


class TestExportTrial:
    """Whole-trial artifact (symbolic time axis) against the live Predictors."""

    @pytest.fixture(scope="class")
    def predictor(self, ckpt_path):
        return Predictor(ckpt_path, chunk_size=CHUNK, length_bucket=BUCKET, device="cpu")

    @pytest.fixture(scope="class")
    def exported(self, predictor):
        return export_trial(predictor, mouse_index=1, src_hw=SRC_HW, platforms=("cpu",))

    @pytest.fixture(scope="class")
    def artifact(self, exported, tmp_path_factory):
        return _saved_and_loaded(exported, tmp_path_factory.mktemp("trial") / "m1.trial.pt2")

    @pytest.fixture(scope="class")
    def jax_artifact(self, ckpt_path, tmp_path_factory):
        exported = jexport.export_trial(JaxPredictor(ckpt_path, chunk_size=CHUNK, length_bucket=BUCKET),
                                        mouse_index=1, src_hw=SRC_HW, platforms=("cpu",))
        return jexport.load_exported(jexport.save_exported(
            tmp_path_factory.mktemp("jtrial") / "m1.trial.stablehlo", exported))

    def _call(self, artifact, video, behavior, pupil_center, length):
        args = _padded_args(video, behavior, pupil_center, length)
        with torch.no_grad():
            out = artifact(*(torch.from_numpy(np.asarray(a)) for a in args))
        return out.numpy()[:, :length]

    @pytest.mark.parametrize("length", [16, 37, 48, 61])
    def test_matches_live_predictor_across_buckets(self, predictor, artifact, length):
        video, behavior, pupil_center = _trial_arrays(length, seed=length)
        want = predictor.predict_trial(video, behavior, pupil_center, 1)
        got = self._call(artifact, video, behavior, pupil_center, length)
        assert got.shape == want.shape == (7, length)
        np.testing.assert_allclose(got, want, rtol=TRIAL_RTOL, atol=TRIAL_ATOL)

    @pytest.mark.parametrize("length", [37, 61])
    def test_matches_the_jax_trial_artifact(self, artifact, jax_artifact, length):
        video, behavior, pupil_center = _trial_arrays(length, seed=length)
        got = self._call(artifact, video, behavior, pupil_center, length)
        want = np.asarray(jax_artifact.call(*_padded_args(video, behavior, pupil_center, length)))[:, :length]
        np.testing.assert_allclose(got, want, rtol=JAX_TRIAL_TOL, atol=JAX_TRIAL_TOL)

    def test_short_trial_is_zeros(self, predictor, artifact):
        # Shorter than one window: no valid anchor, and the clamped blend
        # denominator gives 0s.
        width = predictor.indexes_generator.width
        video, behavior, pupil_center = _trial_arrays(width - 2)
        np.testing.assert_array_equal(self._call(artifact, video, behavior, pupil_center, width - 2), 0.0)

    def test_trial_program_scans_the_custom_ops(self, exported):
        program = exported.program
        targets = [node.target for module in program.graph_module.modules() if isinstance(module, torch.fx.GraphModule)
                   for node in module.graph.nodes]
        assert torch.ops.higher_order.scan in targets
        blocks = len(tiny_params()["nn_module"][1]["core_features"])
        assert targets.count(torch.ops.sensorium.dw_spatial_fwd_bn.default) == blocks  # once, in the scan's body
        assert targets.count(torch.ops.sensorium.dw_temporal_fwd_bn.default) == blocks

    def test_cli_trial_flow(self, ckpt_path, tmp_path, capsys):
        out = tmp_path / "trial.pt2"
        export_cli.main(["-m", str(ckpt_path), "-o", str(out), "--mouse", "1", "--trial", "--src-hw", "12,16",
                         "--chunk", str(CHUNK), "--bucket", str(BUCKET), "--platforms", "cpu", "--device", "cpu",
                         "--check"])
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["trial"] is True and out.exists()
        assert summary["check"]["finite"]
        # The length is the padded time axis: real predictions, not zeros.
        assert summary["check"]["output_shape"] == [7, BUCKET]
        assert summary["check"]["max"] > 0.0

    def test_cli_trial_requires_mouse(self, ckpt_path):
        with pytest.raises(SystemExit, match="--mouse"):
            export_cli.main(["-m", str(ckpt_path), "--trial"])

    @pytest.mark.parametrize(
        "flags, match",
        [
            (["--chunk", "0"], "positive"),
            (["--bucket", "-16"], "positive"),
            (["--bucket", "60", "--chunk", "32"], "multiple"),
            (["--chunk", "8", "--bucket", "16", "--mesh-data", "3"], "mesh-data"),
            (["--chunk", "8", "--bucket", "16", "--mesh-data", "1"], ">= 2"),
            (["--chunk", "8", "--bucket", "16", "--mesh-data", "-4"], ">= 2"),
        ],
    )
    def test_cli_rejects_bad_chunk_bucket(self, ckpt_path, flags, match):
        with pytest.raises(SystemExit, match=match):
            export_cli.main(["-m", str(ckpt_path), "--trial", "--mouse", "0", *flags])

    def test_mesh_data_sign_and_kind_validated(self, ckpt_path, tmp_path):
        kwargs = dict(out_path=tmp_path / "x.pt2", mouse_index=0, src_hw=SRC_HW, chunk_size=CHUNK,
                      length_bucket=BUCKET, platforms=("cpu",), device="cpu")
        for mesh_data in (-4, 1):
            with pytest.raises(ValueError, match=">= 2"):
                export_model_file(ckpt_path, trial=True, mesh_data=mesh_data, **kwargs)
        with pytest.raises(ValueError, match="trial exports only"):
            export_model_file(ckpt_path, mesh_data=4, **kwargs)
        # Cards are counted before anything is loaded (none here; JAX's error).
        with pytest.raises(ValueError, match="needs 1024 local devices"):
            export_model_file(ckpt_path, trial=True, mesh_data=1024, **{**kwargs, "device": "cuda"})
        assert not (tmp_path / "x.pt2").exists()

    def test_bucket_chunk_divisibility_and_frame_size_enforced(self, ckpt_path):
        with pytest.raises(ValueError, match="multiple of chunk_size"):
            export_trial(Predictor(ckpt_path, chunk_size=6, length_bucket=16, device="cpu"), mouse_index=0,
                         platforms=("cpu",))
        with pytest.raises(ValueError, match="exceeds the model canvas"):
            export_trial(Predictor(ckpt_path, chunk_size=8, length_bucket=16, device="cpu"), mouse_index=0,
                         src_hw=(20, 16), platforms=("cpu",))

    def test_predictor_validates_length_bucket(self, ckpt_path):
        with pytest.raises(ValueError, match="length_bucket"):
            Predictor(ckpt_path, chunk_size=8, length_bucket=0, device="cpu")


MESHES = {
    "data4": (lambda: mesh_lib.create_mesh(num_data=4, devices=["cpu"] * 4),
              lambda: jax_mesh.create_mesh(num_data=4), 4, 7),
    "hybrid2x2x2": (lambda: mesh_lib.create_hybrid_mesh(num_slices=2, num_data=2, num_model=2, devices=["cpu"] * 8),
                    lambda: jax_mesh.create_hybrid_mesh(num_slices=2, num_data=2, num_model=2), 8, 11),
}


class TestMeshArtifact:
    """``tests/test_export.py``'s mesh and hybrid trial artifacts: the
    program of a ``Predictor(mesh=)``, each chunk's windows split over the
    replicas (4 over a data mesh; 4 of 2 cards each over the hybrid mesh),
    against the unsharded port ``Predictor`` and the JAX package's artifact
    of the same mesh at rtol 3e-5 / atol 1e-4; ``nr_devices`` and the mesh
    in the artifact; the weights stored once."""

    @pytest.fixture(scope="class")
    def predictor(self, ckpt_path):
        return Predictor(ckpt_path, chunk_size=CHUNK, length_bucket=BUCKET, device="cpu")

    @pytest.fixture(scope="class")
    def single(self, predictor, tmp_path_factory):
        path = tmp_path_factory.mktemp("single") / "m1.trial.pt2"
        return save_exported(path, export_trial(predictor, mouse_index=1, src_hw=SRC_HW, platforms=("cpu",)))

    @pytest.fixture(scope="class", params=sorted(MESHES))
    def artifacts(self, request, ckpt_path, tmp_path_factory):
        port_mesh, jax_mesh_fn, devices, seed = MESHES[request.param]
        work = tmp_path_factory.mktemp(request.param)
        sharded = Predictor(ckpt_path, chunk_size=CHUNK, length_bucket=BUCKET, mesh=port_mesh())
        path = save_exported(work / "mesh.trial.pt2",
                             export_trial(sharded, mouse_index=1, src_hw=SRC_HW, platforms=("cpu",)))
        jax_predictor = JaxPredictor(ckpt_path, chunk_size=CHUNK, length_bucket=BUCKET, mesh=jax_mesh_fn())
        jax_artifact = jexport.load_exported(jexport.save_exported(
            work / "mesh.trial.stablehlo",
            jexport.export_trial(jax_predictor, mouse_index=1, src_hw=SRC_HW, platforms=("cpu",))))
        return path, jax_artifact, devices, seed, sharded

    def test_matches_the_unsharded_predictor_and_the_jax_artifact(self, predictor, artifacts):
        from jax.sharding import NamedSharding, PartitionSpec

        path, jax_artifact, devices, seed, sharded = artifacts
        artifact = load_exported(path, device="cpu")
        assert artifact.nr_devices == jax_artifact.nr_devices == devices
        assert artifact.mesh == sharded.mesh.shape
        length = 37
        video, behavior, pupil_center = _trial_arrays(length, seed=seed)
        want = predictor.predict_trial(video, behavior, pupil_center, 1)
        args = _padded_args(video, behavior, pupil_center, length)
        with torch.no_grad():
            got = artifact(*(torch.from_numpy(np.asarray(a)) for a in args)).numpy()[:, :length]
        assert got.shape == want.shape == (7, length)
        np.testing.assert_allclose(got, want, rtol=TRIAL_RTOL, atol=TRIAL_ATOL)
        np.testing.assert_allclose(got, sharded.predict_trial(video, behavior, pupil_center, 1),
                                   rtol=TRIAL_RTOL, atol=TRIAL_ATOL)
        jax_devices = jax.devices()[:devices]
        rep = NamedSharding(jax.sharding.Mesh(np.asarray(jax_devices), ("d",)), PartitionSpec())
        jax_got = np.asarray(jax_artifact.call(*(jax.device_put(a, rep) for a in args)))[:, :length]
        np.testing.assert_allclose(got, jax_got, rtol=TRIAL_RTOL, atol=TRIAL_ATOL)

    def test_weights_are_stored_once(self, single, artifacts):
        """Every replica runs the first one's stored weights, copied to its
        cards in the program: the artifact holds the one-device artifact's
        weight bytes, not one copy a replica."""
        def weight_bytes(path):
            program = torch.export.load(path)
            tensors = [*program.state_dict.values(), *program.constants.values()]
            return sum(t.numel() * t.element_size() for t in tensors)

        path, _, devices, _, _ = artifacts
        assert weight_bytes(path) == weight_bytes(single)
        graph = torch.export.load(path).graph_module
        targets = [node.target for module in graph.modules() if isinstance(module, torch.fx.GraphModule)
                   for node in module.graph.nodes]
        blocks = len(tiny_params()["nn_module"][1]["core_features"])
        assert targets.count(torch.ops.sensorium.dw_spatial_fwd_bn.default) == blocks * 4  # a forward a replica

    def test_cli_mesh_data_flow(self, ckpt_path, tmp_path, capsys):
        out = tmp_path / "mesh.pt2"
        export_cli.main(["-m", str(ckpt_path), "-o", str(out), "--mouse", "1", "--trial", "--src-hw", "12,16",
                         "--chunk", str(CHUNK), "--bucket", str(BUCKET), "--mesh-data", "4", "--platforms", "cpu",
                         "--device", "cpu", "--check"])
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["nr_devices"] == 4 and summary["mesh"] == {"data": 4, "model": 1}
        assert summary["check"]["finite"] and summary["check"]["output_shape"] == [7, BUCKET]
        assert load_exported(out, device="cpu").nr_devices == 4

    def test_an_artifact_maps_its_devices_onto_the_hosts(self):
        from sensorium_tpu_torch.infer.export import _placement

        traced = ["cuda:0", "cuda:1"]
        assert _placement(traced, torch.device("cpu")) == {"cuda:0": "cpu", "cuda:1": "cpu"}
        # A one-device artifact moves wholesale: traced on "cuda", its graph names "cuda:0".
        assert _placement(["cuda"], torch.device("cpu")) == "cpu"
        assert _placement(["cpu"], torch.device("cpu")) == "cpu"
        with pytest.raises(ValueError, match="pass 'cuda', not cuda:1"):
            _placement(traced, torch.device("cuda", 1))


LOAD_AND_RUN = """
import json, sys
import torch
from sensorium_tpu_torch.infer.export import check_artifact, load_exported
path = sys.argv[1]
out = load_exported(path, device="cpu")(torch.zeros(3, 5, 4, 16, 16))
check = check_artifact(path, batch=2, device="cpu")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "sensorium_tpu")
                or m.startswith(("sensorium_tpu_torch.models", "sensorium_tpu_torch.engine",
                                 "sensorium_tpu_torch.configs", "sensorium_tpu_torch.infer.predictor")))
print(json.dumps({"shape": list(out.shape), "check": check, "loaded": loaded}))
"""


def test_an_artifact_loads_and_runs_without_the_model_code(model, tmp_path):
    path = save_exported(tmp_path / "m0.pt2", export_forward(model, mouse_index=0, platforms=("cpu",)))
    proc = subprocess.run([sys.executable, "-c", LOAD_AND_RUN, str(path)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["shape"] == [3, 5, 4]
    assert result["check"]["finite"] and result["check"]["output_shape"] == [2, 5, 4]
    assert result["loaded"] == []


LOAD_AND_CHECK = """
import json, sys
from sensorium_tpu_torch.infer.export import check_artifact, load_exported
path = sys.argv[1]
module = load_exported(path, device="cpu")
check = check_artifact(path, batch=2, device="cpu")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "sensorium_tpu")
                or m.startswith(("sensorium_tpu_torch.models", "sensorium_tpu_torch.engine",
                                 "sensorium_tpu_torch.configs", "sensorium_tpu_torch.infer.predictor",
                                 "sensorium_tpu_torch.parallel")))
print(json.dumps({"nr_devices": module.nr_devices, "mesh": module.mesh, "check": check, "loaded": loaded}))
"""


def test_a_mesh_artifact_loads_and_runs_without_the_model_code(ckpt_path, tmp_path):
    """The hybrid trial artifact (8 devices) in a process that imports torch
    and the ops module only: no model, engine, predictor or mesh code."""
    mesh = mesh_lib.create_hybrid_mesh(num_slices=2, num_data=2, num_model=2, devices=["cpu"] * 8)
    sharded = Predictor(ckpt_path, chunk_size=CHUNK, length_bucket=BUCKET, mesh=mesh)
    path = save_exported(tmp_path / "hybrid.pt2", export_trial(sharded, mouse_index=0, src_hw=SRC_HW,
                                                               platforms=("cpu",)))
    proc = subprocess.run([sys.executable, "-c", LOAD_AND_CHECK, str(path)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["nr_devices"] == 8 and result["mesh"] == {"replica": 2, "data": 2, "model": 2}
    assert result["check"]["finite"] and result["check"]["output_shape"] == [5, 2 * BUCKET]
    assert result["check"]["max"] > 0.0
    assert result["loaded"] == []


# ------------------------------------------------------------------ custom ops


def _op_cases(dtype):
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)

    x, w, wt = t(2, 3, 9, 8, 8), t(3, 3, 8), t(5, 8)
    dy2 = t(2, 3, 5, 4, 8)
    scale, shift = t(8).float(), t(8).float()
    bn = (t(8).float(), t(8).float().abs() + 0.5, scale, shift)  # mean, var, scale, bias
    act = bn_kernels.bn_act_eval_plain(x, *bn, 1e-5, True)  # the eval BN+SiLU the *_bn ops run inside the convs
    return [
        ("dw_spatial_fwd", (x, w, 2), dw_kernels.dw_spatial_plain(x, w, 2)),
        ("dw_temporal_fwd", (x, wt), dw_kernels.dw_temporal_plain(x, wt)),
        ("dw_spatial_dx", (dy2, w, 2, 9, 8), dw_kernels.dw_spatial_dx_plain(dy2, w, 2, (9, 8))),
        ("dw_spatial_dw", (x, dy2, 3, 2), dw_kernels.dw_spatial_dw_plain(x, dy2, 3, 2)),
        ("dw_temporal_dw", (x, x, 5), dw_kernels.dw_temporal_dw_plain(x, x, 5)),
        ("fused_bn_silu_dw_spatial", (x, scale, shift, w, 1),
         dw_kernels.fused_bn_silu_dw_spatial_plain(x, scale, shift, w, 1)),
        ("dw_spatial_fwd_bn", (x, w, *bn, 1e-5, 2), dw_kernels.dw_spatial_plain(act, w, 2)),
        ("dw_temporal_fwd_bn", (x, wt, *bn, 1e-5), dw_kernels.dw_temporal_plain(act, wt)),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_op_on_the_cpu_is_its_plain_version(dtype):
    for name, args, plain in _op_cases(dtype):
        got = getattr(torch.ops.sensorium, name)(*args)
        assert got.dtype == plain.dtype and torch.equal(got, plain), name
    assert sorted(name for name, _, _ in _op_cases(dtype)) == sorted(dw_kernels.LAUNCHES)


class _Call(torch.nn.Module):
    def __init__(self, name, extra):
        super().__init__()
        self.name, self.extra = name, extra

    def forward(self, *tensors):
        return getattr(torch.ops.sensorium, self.name)(*tensors, *self.extra)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_op_fake_gives_shape_and_dtype_for_a_symbolic_batch(dtype):
    """Each op traced with the batch of its first operand symbolic: the output's
    batch stays symbolic where it has one, and shape and dtype are the plain
    version's."""
    for name, args, plain in _op_cases(dtype):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        extra = args[len(tensors):]
        batch = torch.export.Dim("b", min=1)
        dynamic = [{0: batch} if t.ndim == 5 else None for t in tensors]
        program = torch.export.export(_Call(name, extra), tuple(tensors), dynamic_shapes=(tuple(dynamic),))
        (output,) = [node for node in program.graph.nodes if node.op == "output"]
        value = output.args[0][0].meta["val"]
        assert value.dtype == plain.dtype, name
        if plain.ndim == 5:
            assert isinstance(value.shape[0], torch.SymInt), name
            assert [int(d) for d in value.shape[1:]] == list(plain.shape[1:]), name
        else:
            assert [int(d) for d in value.shape] == list(plain.shape), name
        launches = dict(dw_kernels.LAUNCHES)
        assert torch.equal(program.module()(*tensors), plain), name
        assert dw_kernels.LAUNCHES == launches  # the CPU launches nothing
