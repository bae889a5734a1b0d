"""Typed configuration with a loader for the reference YAML schema.

The on-disk format is the reference ``training.yaml`` (sections ``VERBOSE /
SWINUNET / MODEL / OPTIM / TRAINING``), the same schema the JAX package
reads (``sunet_tf_tpu/config.py``). Of the JAX package's ``TPU`` section
the port reads ``COMPUTE_DTYPE``, the optimizer's moment storage dtypes
(``OPT_MU_DTYPE``, ``OPT_NU_DTYPE``), the mesh (``DATA_PARALLEL``,
``SPATIAL``: the data and spatial sizes of the ranks of a
``torch.distributed`` group, ``parallel/``) and ``DATA_WORKERS`` (the
decode processes of ``data/workers.py``); its other keys (attention
backend, donation) are read past and ignored here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import yaml

COMPUTE_DTYPES = ("bfloat16", "float32")
OPT_MU_DTYPES = ("float32", "bfloat16")
OPT_NU_DTYPES = ("float32", "bfloat16", "bfloat16_sr")


@dataclass(frozen=True)
class SwinUNetConfig:
    """Model hyperparameters (reference training.yaml SWINUNET keys)."""

    img_size: int = 256
    patch_size: int = 4
    win_size: int = 8
    emb_dim: int = 96
    depth_en: tuple = (8, 8, 8, 8)
    head_num: tuple = (8, 8, 8, 8)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    # The reference recipe's constant QK scale (replaces head_dim**-0.5);
    # None means head_dim**-0.5.
    qk_scale: Optional[float] = 8.0
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    ape: bool = False
    patch_norm: bool = True
    use_checkpoint: bool = False
    final_upsample: str = "Dual up-sample"
    in_chans: int = 3
    out_chans: int = 1

    @property
    def num_stages(self) -> int:
        return len(self.depth_en)

    @property
    def patches_resolution(self) -> tuple:
        r = self.img_size // self.patch_size
        return (r, r)


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer/schedule hyperparameters (reference training.yaml OPTIM)."""

    batch: int = 4
    epochs: int = 5
    lr_initial: float = 2e-4
    lr_min: float = 1e-6
    warmup_epochs: int = 3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


@dataclass(frozen=True)
class TrainingConfig:
    """Training-run options (reference training.yaml TRAINING)."""

    val_after_every: int = 1
    resume: bool = False
    train_ps: int = 256
    val_ps: int = 256
    train_dir: str = ""
    val_dir: str = ""
    test_dir: str = ""
    save_dir: str = "./checkpoints"
    seed: int = 85
    steps_per_epoch: int = 0


@dataclass(frozen=True)
class Config:
    swinunet: SwinUNetConfig = field(default_factory=SwinUNetConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    # Matmul/conv dtype; parameters, LayerNorm and softmax stay float32.
    compute_dtype: str = "bfloat16"
    mode: str = "Denoising"
    verbose: bool = False
    # Adam moment storage (train/adam.py): bf16 mu, bf16 nu with stochastic
    # rounding; float32 for both is the exact reference optimizer.
    opt_mu_dtype: str = "bfloat16"
    opt_nu_dtype: str = "bfloat16_sr"
    # The mesh of a multi-rank run (TPU.DATA_PARALLEL, TPU.SPATIAL): the
    # data size (0: the largest divisor of OPTIM.BATCH up to world size /
    # spatial) and the spatial size (> 1 shards the Swin stages' rows).
    data_parallel: int = 0
    spatial: int = 1
    # TPU.DATA_WORKERS: > 0 decodes the training (and evaluation) batches
    # in that many spawned DataLoader workers (data/workers.py).
    data_workers: int = 0

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute dtype must be one of {COMPUTE_DTYPES}, "
                             f"got {self.compute_dtype!r}")
        if self.opt_mu_dtype not in OPT_MU_DTYPES:
            raise ValueError(f"OPT_MU_DTYPE must be one of {OPT_MU_DTYPES}")
        if self.opt_nu_dtype not in OPT_NU_DTYPES:
            raise ValueError(f"OPT_NU_DTYPE must be one of {OPT_NU_DTYPES}")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _get(d: dict, key: str, default: Any) -> Any:
    v = d.get(key, default)
    return default if v is None else v


def _as_tuple(x: Any) -> tuple:
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


def config_from_dict(raw: dict) -> Config:
    """Build a Config from a reference-schema dict (yaml.safe_load output)."""
    sw = raw.get("SWINUNET", {}) or {}
    qk = sw.get("QK_SCALE", 8)
    swin = SwinUNetConfig(
        img_size=int(_get(sw, "IMG_SIZE", 256)),
        patch_size=int(_get(sw, "PATCH_SIZE", 4)),
        win_size=int(_get(sw, "WIN_SIZE", 8)),
        emb_dim=int(_get(sw, "EMB_DIM", 96)),
        depth_en=_as_tuple(_get(sw, "DEPTH_EN", (8, 8, 8, 8))),
        head_num=_as_tuple(_get(sw, "HEAD_NUM", (8, 8, 8, 8))),
        mlp_ratio=float(_get(sw, "MLP_RATIO", 4.0)),
        qkv_bias=bool(_get(sw, "QKV_BIAS", True)),
        qk_scale=None if qk in (None, "None", 0) else float(qk),
        drop_rate=float(_get(sw, "DROP_RATE", 0.0)),
        attn_drop_rate=float(_get(sw, "ATTN_DROP_RATE", 0.0)),
        drop_path_rate=float(_get(sw, "DROP_PATH_RATE", 0.1)),
        ape=bool(_get(sw, "APE", False)),
        patch_norm=bool(_get(sw, "PATCH_NORM", True)),
        use_checkpoint=bool(_get(sw, "USE_CHECKPOINTS", False)),
        final_upsample=str(_get(sw, "FINAL_UPSAMPLE", "Dual up-sample")),
        in_chans=int(_get(sw, "IN_CHANS", 3)),
        out_chans=int(_get(sw, "OUT_CHANS", 1)),
    )
    op = raw.get("OPTIM", {}) or {}
    optim = OptimConfig(
        batch=int(_get(op, "BATCH", 4)),
        epochs=int(_get(op, "EPOCHS", 5)),
        lr_initial=float(_get(op, "LR_INITIAL", 2e-4)),
        lr_min=float(_get(op, "LR_MIN", 1e-6)),
        warmup_epochs=int(_get(op, "WARMUP_EPOCHS", 3)),
    )
    tr = raw.get("TRAINING", {}) or {}
    training = TrainingConfig(
        val_after_every=int(_get(tr, "VAL_AFTER_EVERY", 1)),
        resume=bool(_get(tr, "RESUME", False)),
        train_ps=int(_get(tr, "TRAIN_PS", 256)),
        val_ps=int(_get(tr, "VAL_PS", 256)),
        train_dir=str(_get(tr, "TRAIN_DIR", "")),
        val_dir=str(_get(tr, "VAL_DIR", "")),
        test_dir=str(_get(tr, "TEST_DIR", "")),
        save_dir=str(_get(tr, "SAVE_DIR", "./checkpoints")),
        seed=int(_get(tr, "SEED", 85)),
        steps_per_epoch=int(_get(tr, "STEPS_PER_EPOCH", 0)),
    )
    tp = raw.get("TPU", {}) or {}
    model = raw.get("MODEL", {}) or {}
    return Config(
        swinunet=swin,
        optim=optim,
        training=training,
        compute_dtype=str(_get(tp, "COMPUTE_DTYPE", "bfloat16")),
        mode=str(_get(model, "MODE", "Denoising")),
        verbose=bool(_get(raw, "VERBOSE", False)),
        opt_mu_dtype=str(_get(tp, "OPT_MU_DTYPE", "bfloat16")),
        opt_nu_dtype=str(_get(tp, "OPT_NU_DTYPE", "bfloat16_sr")),
        data_parallel=int(_get(tp, "DATA_PARALLEL", 0)),
        spatial=int(_get(tp, "SPATIAL", 1)),
        data_workers=int(_get(tp, "DATA_WORKERS", 0)),
    )


def load_config(path: str) -> Config:
    """Load a reference-schema training.yaml into a typed Config."""
    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    return config_from_dict(raw)


def config_to_dict(cfg: Config) -> dict:
    """Round-trip back to the reference YAML schema."""
    sw = cfg.swinunet
    return {
        "VERBOSE": cfg.verbose,
        "SWINUNET": {
            "IMG_SIZE": sw.img_size,
            "PATCH_SIZE": sw.patch_size,
            "WIN_SIZE": sw.win_size,
            "EMB_DIM": sw.emb_dim,
            "DEPTH_EN": list(sw.depth_en),
            "HEAD_NUM": list(sw.head_num),
            "MLP_RATIO": sw.mlp_ratio,
            "QKV_BIAS": sw.qkv_bias,
            "QK_SCALE": sw.qk_scale,
            "DROP_RATE": sw.drop_rate,
            "ATTN_DROP_RATE": sw.attn_drop_rate,
            "DROP_PATH_RATE": sw.drop_path_rate,
            "APE": sw.ape,
            "PATCH_NORM": sw.patch_norm,
            "USE_CHECKPOINTS": sw.use_checkpoint,
            "FINAL_UPSAMPLE": sw.final_upsample,
            "IN_CHANS": sw.in_chans,
            "OUT_CHANS": sw.out_chans,
        },
        "MODEL": {"MODE": cfg.mode},
        "OPTIM": {
            "BATCH": cfg.optim.batch,
            "EPOCHS": cfg.optim.epochs,
            "LR_INITIAL": cfg.optim.lr_initial,
            "LR_MIN": cfg.optim.lr_min,
            "WARMUP_EPOCHS": cfg.optim.warmup_epochs,
        },
        "TRAINING": {
            "VAL_AFTER_EVERY": cfg.training.val_after_every,
            "RESUME": cfg.training.resume,
            "TRAIN_PS": cfg.training.train_ps,
            "VAL_PS": cfg.training.val_ps,
            "TRAIN_DIR": cfg.training.train_dir,
            "VAL_DIR": cfg.training.val_dir,
            "TEST_DIR": cfg.training.test_dir,
            "SAVE_DIR": cfg.training.save_dir,
            "SEED": cfg.training.seed,
        },
        "TPU": {"COMPUTE_DTYPE": cfg.compute_dtype,
                "OPT_MU_DTYPE": cfg.opt_mu_dtype,
                "OPT_NU_DTYPE": cfg.opt_nu_dtype,
                "DATA_PARALLEL": cfg.data_parallel,
                "SPATIAL": cfg.spatial,
                "DATA_WORKERS": cfg.data_workers},
    }


def scaled_config(**overrides) -> Config:
    """The scaled SUNet: EMB_DIM 180, WIN_SIZE 16, 512x512 patches, heads
    6/12/24/48 so that every stage has head dim 30, QK scale head_dim**-0.5
    (``qk_scale=None``). ``overrides`` of SwinUNetConfig fields replace
    these; other keys are ignored."""
    base = dict(
        img_size=512,
        patch_size=4,
        win_size=16,
        emb_dim=180,
        depth_en=(8, 8, 8, 8),
        head_num=(6, 12, 24, 48),
        qk_scale=None,
    )
    base.update({k: v for k, v in overrides.items()
                 if k in SwinUNetConfig.__dataclass_fields__})
    return Config(swinunet=SwinUNetConfig(**base),
                  training=TrainingConfig(train_ps=512, val_ps=512))


def tiny_config(**overrides) -> Config:
    """A small config for tests: same topology, tiny dims."""
    swin = SwinUNetConfig(
        img_size=64,
        patch_size=4,
        win_size=4,
        emb_dim=16,
        depth_en=(2, 2, 2, 2),
        head_num=(2, 2, 2, 2),
        drop_path_rate=0.1,
        **{k: v for k, v in overrides.items()
           if k in SwinUNetConfig.__dataclass_fields__},
    )
    return Config(swinunet=swin, training=TrainingConfig(train_ps=64, val_ps=64))
