"""Experiment config: the competition-winning "true batch" recipe.

The port's copy of ``configs/true_batch_001.py``: global batch 32 with
unchunked BN statistics, 9-block DwiseNeuro core with expansion ratio 7,
7-fold CV, EMA decay 0.999, CutMix(alpha=1, prob=0.5), linear-warmup +
cosine LR with linear batch-size scaling. Every value is the JAX file's
apart from ``device``, which names the card; ``amp`` means bf16 compute
(no GradScaler).

Configs are executable Python exposing a module-level ``config`` dict,
loaded by ``sensorium_tpu_torch.cli.train`` with ``SourceFileLoader``.
They import only the port.
"""

from sensorium_tpu_torch import constants
from sensorium_tpu_torch.utils.misc import get_lr

image_size = (64, 64)
batch_size = 32
base_lr = 3e-4
frame_stack_size = 16

config = dict(
    image_size=image_size,
    batch_size=batch_size,
    base_lr=base_lr,
    min_base_lr=base_lr * 0.01,
    ema_decay=0.999,
    train_epoch_size=72000,
    num_epochs=[3, 18],
    stages=["warmup", "train"],
    num_dataloader_workers=8,
    init_weights=True,
    argus_params={
        "nn_module": (
            "dwiseneuro",
            {
                "readout_outputs": constants.num_neurons,
                "in_channels": 5,
                "core_features": (64, 64, 64, 64, 128, 128, 128, 256, 256),
                "spatial_strides": (2, 1, 1, 1, 2, 1, 1, 2, 1),
                "spatial_kernel": 3,
                "temporal_kernel": 5,
                "expansion_ratio": 7,
                "se_reduce_ratio": 32,
                "cortex_features": (1024, 2048, 4096),
                "groups": 2,
                "softplus_beta": 0.07,
                "drop_rate": 0.4,
                "drop_path_rate": 0.1,
                "dtype": "bfloat16",
                # Recompute core block 1 in the backward and store the
                # others: a batch-32 step then peaks at 38.53 GB of an
                # H100's 80 GB (chip_smoke.py phase 7, PERF.md section 5).
                "remat_blocks": (1,),
            },
        ),
        "loss": ("mice_poisson", {"log_input": False, "full": False, "eps": 1e-8}),
        "optimizer": ("AdamW", {"lr": get_lr(base_lr, batch_size), "weight_decay": 0.05}),
        "device": "cuda",
        "frame_stack": {"size": frame_stack_size, "step": 2, "position": "last"},
        "inputs_processor": ("stack_inputs", {"size": image_size, "pad_fill_value": 0.0}),
        "responses_processor": ("identity", {}),
        "amp": True,
        "iter_size": 1,
    },
    cutmix={"alpha": 1.0, "prob": 0.5},
)
