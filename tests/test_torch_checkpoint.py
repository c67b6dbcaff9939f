"""The port's checkpoints against the JAX package's, on the CPU.

* The msgpack codec (``sensorium_tpu_torch/utils/msgpack.py``) writes the
  bytes ``flax.serialization.msgpack_serialize`` writes and reads flax's
  back, chunked arrays included.
* A model checkpoint written by either package loads in the other and
  predicts within ``tests/test_torch_model.py``'s tolerances (rtol 1e-4,
  atol 1e-5).
* Save and load, resume after a step and after a preemption at an epoch
  boundary, and a background save are bitwise equal to what they stand for.
* ``Checkpoint`` keeps the best k; ``init_from_checkpoint`` warm-starts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from sensorium_tpu.engine.checkpoint import save_model_checkpoint as jax_save_model_checkpoint
from sensorium_tpu.engine.model import MouseModel as JaxMouseModel
from sensorium_tpu.engine.model import load_model as jax_load_model
from sensorium_tpu_torch.compat import from_jax_variables
from sensorium_tpu_torch.engine import checkpoint as ckpt
from sensorium_tpu_torch.engine.callbacks import Callback, Checkpoint, EngineState
from sensorium_tpu_torch.engine.metrics import CorrelationMetric
from sensorium_tpu_torch.engine.model import MouseModel, load_model
from sensorium_tpu_torch.engine.preemption import PreemptionHandler, TrainingPreempted
from sensorium_tpu_torch.engine.schedule import warmup_cosine
from sensorium_tpu_torch.models.registry import get_nn_module
from sensorium_tpu_torch.utils import msgpack
from sensorium_tpu_torch.utils.misc import get_best_model_path
from tests.test_engine import FakeLoader, random_batch, tiny_params

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_model.py


def leaves_payload(bf16) -> dict:
    """Every kind of leaf the codec takes; ``bf16`` makes the bf16 array."""
    rng = np.random.default_rng(0)
    return {
        "nested": {"b": {"c": [1, 2.5, None, True, False, "text"]}, "a": -3},
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129, -32769, -2**31 - 1],
        "floats": [0.0, -1.5, 1e300, 2.4e-3],
        "strings": ["", "s" * 31, "m" * 32, "l" * 300, "ünïcode"],
        "bytes": b"\x00\x01raw",
        "fp32": rng.normal(size=(3, 5)).astype(np.float32),
        "int32": np.arange(-4, 20, dtype=np.int32).reshape(2, 3, 4),
        "uint8": rng.integers(0, 255, 300, dtype=np.uint8),
        "zero_d": np.asarray(7, np.int32),
        "scalar": np.float32(0.25),
        "empty": np.zeros((0, 4), np.float32),
        "big": rng.normal(size=70000).astype(np.float32),
        "bf16": bf16(rng.normal(size=(4, 6)).astype(np.float32)),
        "list_of_arrays": [np.ones(3, np.float64), {"k": np.uint32(5)}],
    }


def jax_model_payload() -> dict:
    model = JaxMouseModel(tiny_params())
    model.set_ema(0.9)
    model.build_state(seed=0, learning_rate=1e-3)
    return {"version": 1, "model_name": "MouseModel", "params": {"config": [1, "two"], "lr": 1e-3},
            "nn_state": model.eval_variables()}


def jax_train_state_payload() -> dict:
    model = JaxMouseModel(tiny_params())
    model.set_ema(0.9)
    model.build_state(seed=0, learning_rate=1e-3)
    model.train_step(random_batch(np.random.default_rng(1)))
    state = jax.device_get(serialization.to_state_dict(model.state))
    return {"version": 1, "params": {"x": 1}, "state": state, "extra": {"epoch": 2, "val_corr": 0.25}}


def assert_same_tree(port, ref, path="tree"):
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == sorted(ref), path
        for key in ref:
            assert_same_tree(port[key], ref[key], f"{path}.{key}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(port, list) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(port, torch.Tensor):  # bf16
        assert str(np.asarray(ref).dtype) == "bfloat16", path
        np.testing.assert_array_equal(port.float().numpy(), np.asarray(ref, np.float32), err_msg=path)
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(port) is type(ref) and port.dtype == ref.dtype, path
        np.testing.assert_array_equal(port, ref, err_msg=path)
    else:
        assert type(port) is type(ref) and port == ref, path


@pytest.mark.parametrize("payload", ["leaves", "model", "train_state"])
def test_codec_writes_flax_bytes_and_reads_flax_back(payload):
    if payload == "leaves":
        ref = leaves_payload(lambda a: a.astype(jnp.bfloat16))
        port = leaves_payload(lambda a: torch.from_numpy(a).to(torch.bfloat16))
    else:
        ref = jax_model_payload() if payload == "model" else jax_train_state_payload()
        port = ref
    expected = serialization.msgpack_serialize(ref)
    assert msgpack.msgpack_serialize(port) == expected
    assert b"".join(msgpack.msgpack_pieces(port)) == expected
    assert_same_tree(msgpack.msgpack_restore(expected), serialization.msgpack_restore(expected))
    assert_same_tree(serialization.msgpack_restore(msgpack.msgpack_serialize(port)),
                     serialization.msgpack_restore(expected))


def test_codec_chunks_large_arrays_as_flax_does(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 1000)
    rng = np.random.default_rng(2)
    tree = {
        "a": {"w": rng.normal(size=(30, 20)).astype(np.float32), "small": np.arange(7, dtype=np.int8)},
        "half": rng.normal(size=1001).astype(np.float16),
        "in_list": [rng.normal(size=600).astype(np.float32)],  # flax chunks through dicts only
    }
    expected = serialization.msgpack_serialize(tree)
    assert msgpack.msgpack_serialize(tree) == expected
    assert msgpack.msgpack_serialize(tree).count(b"__msgpack_chunked_array__") == 2
    restored = msgpack.msgpack_restore(bytearray(expected))
    assert_same_tree(restored, serialization.msgpack_restore(expected))
    np.testing.assert_array_equal(restored["a"]["w"], tree["a"]["w"])
    bf = torch.from_numpy(rng.normal(size=900).astype(np.float32)).to(torch.bfloat16)
    written = msgpack.msgpack_serialize({"bf": bf})
    assert written == serialization.msgpack_serialize({"bf": np.asarray(bf.float().numpy(), jnp.bfloat16)})
    assert torch.equal(msgpack.msgpack_restore(written)["bf"], bf)


def jax_tiny_model(seed: int = 0) -> JaxMouseModel:
    """A JAX tiny model with BN statistics and biases drawn so that they matter."""
    model = JaxMouseModel(tiny_params())
    model.build_state(seed=seed, learning_rate=0.0)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name, leaf = path[-1].key, np.asarray(leaf)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name in ("mean", "bias", "readout_bias"):
            return rng.normal(0, 0.3, leaf.shape).astype(np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(perturb, jax.device_get(model.state.params))
    stats = jax.tree_util.tree_map_with_path(perturb, jax.device_get(model.state.batch_stats))
    model.state = model.state.replace(params=params, batch_stats=stats)
    return model


def sample_inputs(seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 255, (2, 5, 4, 16, 16)).astype(np.float32)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    model = jax_tiny_model()
    path = tmp_path / "model-001-0.500000.ckpt"
    model.save(path)
    restored = load_model(path, device="cpu")
    direct = get_nn_module(*tiny_params()["nn_module"], device="cpu")
    variables = model.eval_variables()
    direct.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]), strict=True)
    inputs = sample_inputs()
    got = restored.predict(inputs, mouse_index=1).numpy()
    with torch.inference_mode():
        expected = direct.eval()(torch.from_numpy(inputs), mouse_index=1).numpy()
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_allclose(got, np.asarray(model.predict(inputs, mouse_index=1)), rtol=RTOL, atol=ATOL)
    assert restored.params["nn_module"][1]["core_features"] == [8, 8]  # the JSON round trip's lists


def port_model(seed: int = 0, ema: float = 0.9, learning_rate=1e-3) -> MouseModel:
    model = MouseModel(tiny_params(), device="cpu")
    model.set_ema(ema)
    model.build_state(seed=seed, learning_rate=learning_rate)
    return model


def test_port_checkpoint_loads_in_jax(tmp_path):
    model = port_model()
    model.train_step(random_batch(np.random.default_rng(4)))
    path = tmp_path / "model-002-0.250000.ckpt"
    model.save(path)
    inputs = sample_inputs()
    expected = model.predict(inputs, mouse_index=0).numpy()
    restored = jax_load_model(path)
    np.testing.assert_allclose(np.asarray(restored.predict(inputs, mouse_index=0)), expected, rtol=RTOL, atol=ATOL)
    # Written by the JAX package, the same weights give the same bytes.
    jax_save_model_checkpoint(tmp_path / "jax.ckpt", tiny_params(), jax.device_get(restored.eval_variables()))
    assert (tmp_path / "jax.ckpt").read_bytes() == path.read_bytes()


def test_save_and_load_round_trip_is_bitwise(tmp_path):
    model = port_model()
    model.train_step(random_batch(np.random.default_rng(5)))
    model.save(tmp_path / "model.ckpt")
    restored = load_model(tmp_path / "model.ckpt", device="cpu")
    saved = model.state.eval_model.state_dict()
    loaded = restored.state.model.state_dict()
    assert list(saved) == list(loaded)
    for name in saved:
        assert torch.equal(saved[name], loaded[name]), name
    inputs = sample_inputs()
    assert torch.equal(restored.predict(inputs, mouse_index=1), model.predict(inputs, mouse_index=1))


def assert_states_equal(a: MouseModel, b: MouseModel) -> None:
    for module_a, module_b in ((a.state.model, b.state.model), (a.state.ema_model, b.state.ema_model)):
        sd_a, sd_b = module_a.state_dict(), module_b.state_dict()
        assert list(sd_a) == list(sd_b)
        for name in sd_a:
            assert torch.equal(sd_a[name], sd_b[name]), name
    opt_a, opt_b = a.state.optimizer.state_dict()["state"], b.state.optimizer.state_dict()["state"]
    assert opt_a.keys() == opt_b.keys() and opt_a
    for index in opt_a:
        for key in opt_a[index]:
            assert torch.equal(opt_a[index][key], opt_b[index][key]), (index, key)
    assert torch.equal(a.state.generator.get_state(), b.state.generator.get_state())
    assert a.state.step == b.state.step


def scheduled_model(seed: int) -> MouseModel:
    # A warmup + cosine plan makes the update count matter on resume.
    return port_model(seed=seed, learning_rate=warmup_cosine(1e-3, 1e-5, 2, 4))


def test_step_level_resume_is_bitwise(tmp_path):
    """After tests/test_engine.py TestResumeEquivalence: 3 steps, save, load
    into a model from another seed, 3 steps == 6 steps uninterrupted."""
    rng = np.random.default_rng(5)
    batches = [random_batch(rng) for _ in range(6)]
    continuous = scheduled_model(seed=0)
    losses_full = [float(continuous.train_step(b)) for b in batches]

    first = scheduled_model(seed=0)
    for b in batches[:3]:
        first.train_step(b)
    first.save_train_state(tmp_path / "mid.ckpt", extra={"epoch": 0})
    resumed = scheduled_model(seed=99)
    assert resumed.load_train_state(tmp_path / "mid.ckpt") == {"epoch": 0}
    losses_tail = [float(resumed.train_step(b)) for b in batches[3:]]
    assert losses_tail == losses_full[3:]
    assert_states_equal(resumed, continuous)


class PreemptAfterEpoch(Callback):
    def __init__(self, handler, epoch: int):
        self.handler, self.epoch = handler, epoch

    def epoch_complete(self, state):
        if state.global_epoch == self.epoch:
            self.handler.triggered = True


def test_preemption_resume_at_an_epoch_boundary_is_bitwise(tmp_path):
    rng = np.random.default_rng(6)
    loader = FakeLoader([random_batch(rng) for _ in range(3)])
    save_path = tmp_path / "preempt.ckpt"
    continuous = scheduled_model(seed=0)
    continuous.fit(loader, num_epochs=2)

    interrupted = scheduled_model(seed=0)
    with PreemptionHandler() as handler:
        with pytest.raises(TrainingPreempted):
            interrupted.fit(loader, num_epochs=2, callbacks=[PreemptAfterEpoch(handler, 0)], preemption=handler,
                            preemption_save_path=save_path)
    resumed = scheduled_model(seed=77)
    assert resumed.load_train_state(save_path) == {"epoch": 0}  # epoch 0 fully committed
    resumed.fit(loader, num_epochs=1, start_epoch=1)
    assert_states_equal(resumed, continuous)


def test_preemption_mid_epoch_saves_and_isolates_fit_complete(tmp_path):
    class Exploding(Callback):
        def fit_complete(self, state):
            raise RuntimeError("cleanup failed")

    class Recorder(Callback):
        called = False

        def fit_complete(self, state):
            Recorder.called = True

    model = port_model(ema=0.0)
    loader = FakeLoader([random_batch(np.random.default_rng(3)) for _ in range(3)])
    save_path = tmp_path / "train_state.ckpt"
    with PreemptionHandler() as handler:
        handler.triggered = True
        with pytest.raises(TrainingPreempted):
            model.fit(loader, num_epochs=2, start_epoch=4, callbacks=[Exploding(), Recorder()], preemption=handler,
                      preemption_save_path=save_path)
    assert Recorder.called
    resumed = port_model(seed=9, ema=0.0)
    assert resumed.load_train_state(save_path) == {"epoch": 3}  # epoch 4 was cut short
    assert resumed.state.step == 1


def test_background_save_is_bitwise_a_sync_save(tmp_path):
    model = port_model()
    batch = random_batch(np.random.default_rng(7))
    model.train_step(batch)
    model.save(tmp_path / "sync.ckpt")
    model.save(tmp_path / "async.ckpt", background=True)
    model.save_train_state(tmp_path / "sync_state.ckpt", extra={"epoch": 1})
    model.save_train_state(tmp_path / "async_state.ckpt", extra={"epoch": 1}, background=True)
    # The step updates the weights, EMA and moments in place while the
    # write may still be in flight: the host copy was made before.
    model.train_step(batch)
    ckpt.flush_pending_saves()
    assert (tmp_path / "async.ckpt").read_bytes() == (tmp_path / "sync.ckpt").read_bytes()
    assert (tmp_path / "async_state.ckpt").read_bytes() == (tmp_path / "sync_state.ckpt").read_bytes()


def test_load_joins_the_pending_write_and_errors_surface(tmp_path):
    model = port_model(ema=0.0)
    path = tmp_path / "model-001-0.100000.ckpt"
    model.save(path, background=True)
    restored = load_model(path, device="cpu")  # joins the write
    inputs = sample_inputs(8)
    assert torch.equal(restored.predict(inputs, mouse_index=1), model.predict(inputs, mouse_index=1))
    model.save(tmp_path / "no_such_dir" / "x.ckpt", background=True)
    with pytest.raises(FileNotFoundError):
        ckpt.flush_pending_saves()
    ckpt.flush_pending_saves()  # the error is consumed; the writer is reusable


def test_sharded_train_state_is_refused(tmp_path):
    """The sharded (``.orbax``) train state, once refused, now round-trips
    over a gloo group of one (every collective of the format runs): 3 AdamW
    steps, save, load into a model from another seed, 3 steps == 6 steps
    uninterrupted, bitwise; the directory holds meta.json with JAX's keys."""
    import json

    import torch.distributed as dist

    from sensorium_tpu_torch.parallel import mesh as mesh_lib
    from tests.test_torch_parallel import free_port

    rng = np.random.default_rng(6)
    batches = [random_batch(rng) for _ in range(6)]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        mesh = mesh_lib.create_mesh()

        def model(seed):
            built = MouseModel(tiny_params(), device="cpu", mesh=mesh)
            built.set_ema(0.9)
            built.build_state(seed=seed, learning_rate=warmup_cosine(1e-3, 1e-5, 2, 4))
            return built

        continuous = model(0)
        losses_full = [float(continuous.train_step(b)) for b in batches]
        first = model(0)
        for b in batches[:3]:
            first.train_step(b)
        first.save_train_state(tmp_path / "train_state.orbax", extra={"epoch": 4})
        resumed = model(99)
        assert resumed.load_train_state(tmp_path / "train_state.orbax") == {"epoch": 4}
        assert [float(resumed.train_step(b)) for b in batches[3:]] == losses_full[3:]
        assert_states_equal(resumed, continuous)
    finally:
        dist.destroy_process_group()
    meta = json.loads((tmp_path / "train_state.orbax" / "meta.json").read_text())
    assert set(meta) == {"version", "params", "extra"} and meta["extra"] == {"epoch": 4}


class FakeSaver:
    def save(self, path, background=False):
        path.write_bytes(b"model")

    def save_train_state(self, path, extra=None, background=False):
        path.write_bytes(b"state")


@pytest.mark.parametrize("monitor, better, keep", [
    ("val_corr", "max", ["3.000000", "2.000000"]),
    ("val_loss", "min", ["1.000000", "0.500000"]),
    ("val_loss", "auto", ["1.000000", "0.500000"]),
    ("val_corr", "auto", ["3.000000", "2.000000"]),
])
def test_checkpoint_keeps_the_best_k(tmp_path, monitor, better, keep):
    callback = Checkpoint(tmp_path, file_format="model-{epoch:03d}-{%s:.6f}.ckpt" % monitor, monitor=monitor,
                          better=better, max_saves=2)
    state = EngineState(model=FakeSaver())
    for epoch, score in enumerate([2.0, 1.0, 3.0, 0.5]):
        state.global_epoch = epoch
        state.metrics = {monitor: score}
        callback.epoch_complete(state)
    kept = sorted(p.name.split("-")[-1][:-5] for p in tmp_path.glob("model-*.ckpt"))
    assert kept == sorted(keep)
    assert (tmp_path / "train_state.ckpt").read_bytes() == b"state"


def test_checkpoint_refuses_an_unknown_better(tmp_path):
    with pytest.raises(ValueError, match="better"):
        Checkpoint(tmp_path, better="maximize")


def test_fit_with_a_background_checkpoint_callback(tmp_path):
    model = port_model()
    loader = FakeLoader([random_batch(np.random.default_rng(9)) for _ in range(3)])
    model.fit(loader, val_loader=loader, num_epochs=2, callbacks=[Checkpoint(tmp_path, max_saves=1, background=True)],
              metrics=[CorrelationMetric(num_neurons=[5, 7])])
    ckpt.flush_pending_saves()
    best = get_best_model_path(tmp_path)
    assert best is not None and len(list(tmp_path.glob("model-*.ckpt"))) == 1
    restored = load_model(best, device="cpu")
    assert torch.isfinite(restored.predict(loader.batches[0].inputs[:1], mouse_index=1)).all()
    resumed = port_model(seed=3)
    assert resumed.load_train_state(tmp_path / "train_state.ckpt")["epoch"] == 1
    assert resumed.state.step == 6


def test_init_from_checkpoint_warm_starts(tmp_path):
    source = jax_tiny_model(seed=1)
    source.save(tmp_path / "source.ckpt")
    model = port_model(seed=0)
    model.init_from_checkpoint(tmp_path / "source.ckpt")
    variables = source.eval_variables()
    expected = from_jax_variables(variables["params"], variables["batch_stats"])
    for module in (model.state.model, model.state.ema_model):
        for name, value in module.state_dict().items():
            assert torch.equal(value, expected[name]), name
    live = dict(model.state.model.named_parameters())
    assert all(p.data_ptr() != live[name].data_ptr() for name, p in model.state.ema_model.named_parameters())
    assert model.state.step == 0 and not model.state.optimizer.state

    name, params = tiny_params()["nn_module"]
    other = MouseModel({**tiny_params(), "nn_module": (name, {**params, "cortex_features": (16, 32)})}, device="cpu")
    other.build_state(seed=0)
    with pytest.raises(ValueError, match="architecture mismatch"):
        other.init_from_checkpoint(tmp_path / "source.ckpt")
