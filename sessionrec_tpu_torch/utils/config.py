"""Dataclass configuration with per-model presets.

Reproduces the reference's flag defaults for the fields this port reads
(SURVEY.md §5): LESSR main_lessr.py:11-52, NISER main_niser.py:11-52,
MSGIFSR main_msgifsr.py:36-111; shared trainer defaults train.py:74-75.
SRGNN has no reference script (start.sh:6 points at a missing file); its
preset is NISER's wiring with SRGNN's model, as in the JAX package.

A copy of ``sessionrec_tpu/utils/config.py`` (the port imports nothing
of the JAX package) with the fields the PyTorch trainer reads, so
``preset`` raises ``KeyError`` on an option the port does not implement
instead of ignoring it, and ``ValueError`` on a dtype other than float32
and bfloat16.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class DataConfig:
    dataset_dir: str = "datasets/sample"
    batch_size: int = 512
    shuffle_train: bool = False   # ordered stream (README.md:37)
    valid_split: float | None = None
    max_len: int | None = None    # static node cap; None -> computed from data
    # Length-bucketed batches: each threshold adds a tier of examples
    # (by prefix length) built at its own smaller static node cap (the
    # same example set per step — graph/batch.py:SplitBatch).  Default ON
    # at (4, 8); --split-len 0 disables; thresholds >= the data's max
    # length drop out automatically.
    split_len: int | tuple | None = (4, 8)
    num_prefetch: int = 2
    # build batches with the C++ builder (data/native_collate.py); False
    # runs the pure-Python builders (graph/builders.py)
    use_native_collate: bool = True


@dataclass
class ModelConfig:
    name: str = "msgifsr"         # srgnn | niser | lessr | msgifsr
    embedding_dim: int = 256
    num_layers: int = 1
    feat_drop: float = 0.1
    # NISER and MSGIFSR: l2-normalised table and session vectors
    norm: bool = True
    scale: float = 12.0           # NISER's logit scale
    # MSGIFSR
    order: int = 1
    reducer: str = "mean"         # SemanticExpander reducer: mean|max|concat
    extra: bool = False           # REnorm (store_true flag, default off)
    fusion: bool = False          # IFR (store_true flag, default off)
    # LESSR
    batch_norm: bool = True
    # SRGNN/NISER parity quirk (SURVEY.md §7.4): the reference's readout
    # reads the pre-GNN embedding, leaving the GNN output unused
    # (srgnn.py:141-142); False feeds it the GNN output
    readout_on_embedding: bool = True
    # numerics: the layers' compute dtype (the float32 master parameters
    # are cast to it in each forward), and the item table's storage dtype;
    # a bfloat16 table keeps float32 Adam moments and rounds its updates
    # stochastically (ops/sround.py)
    compute_dtype: str = "float32"
    table_dtype: str = "float32"


DTYPES = ("float32", "bfloat16")


@dataclass
class TrainConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-4
    epochs: int = 30
    patience: int = 3
    log_interval: int = 100
    seed: int = 123
    lr_step_size: int = 3         # StepLR(step_size=3, gamma=0.1), train.py:75
    lr_gamma: float = 0.1
    cutoff: int = 20              # HR@K / MRR@K
    eval_before_train: bool = True  # reference evaluates once pre-training (train.py:91)
    # PyTorch device of the trainer; "cpu" must be asked for explicitly
    device: str = "cuda"
    # optimizer steps per dispatch: on CUDA one captured CUDA graph replays
    # this many steps (train/runner.py); the CPU runs them one by one
    unroll: int = 8
    # checkpoint/resume (utils/checkpoint.py; absent in the reference)
    checkpoint_dir: str | None = None
    checkpoint_every_epochs: int = 1
    resume: bool = False
    # parallelism: a (data, model) mesh of data_parallel x model_parallel
    # ranks, one process each (parallel/mesh.py)
    data_parallel: int = 1
    model_parallel: int = 1
    # observability (absent in the reference, SURVEY.md §5)
    metrics_file: str | None = None   # JSONL sink (utils/metrics.py)
    profile_dir: str | None = None    # torch.profiler trace dir


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


_PRESETS = {
    # main_lessr.py defaults: dim 32, 3 layers, drop 0.2, bs 512, patience 2
    "lessr": dict(model=dict(name="lessr", embedding_dim=32, num_layers=3,
                             feat_drop=0.2),
                  data=dict(batch_size=512, shuffle_train=False),
                  train=dict(patience=2)),
    # main_niser.py defaults: dim 64, 2 layers, drop 0.5, bs 128, shuffled
    "niser": dict(model=dict(name="niser", embedding_dim=64, num_layers=2,
                             feat_drop=0.5),
                  data=dict(batch_size=128, shuffle_train=True),
                  train=dict(patience=2)),
    # no reference script exists; NISER-like wiring, SRGNN model
    "srgnn": dict(model=dict(name="srgnn", embedding_dim=64, num_layers=2,
                             feat_drop=0.5),
                  data=dict(batch_size=128, shuffle_train=True),
                  train=dict(patience=2)),
    # main_msgifsr.py defaults: dim 256, 1 layer, drop 0.1, bs 512,
    # patience 3, order 3 (start.sh:10 runs --order 1)
    "msgifsr": dict(model=dict(name="msgifsr", embedding_dim=256, num_layers=1,
                               feat_drop=0.1, order=3),
                    data=dict(batch_size=512, shuffle_train=False),
                    train=dict(patience=3)),
}


def preset(name: str, **overrides) -> Config:
    """Build a Config from a model preset, with dotted-field overrides.

    ``preset('msgifsr', order=1, dataset_dir='...', lr=5e-4)`` — override
    keys are matched against whichever sub-config defines them.
    """
    spec = _PRESETS[name.lower()]
    cfg = Config()
    for section, kv in spec.items():
        sub = getattr(cfg, section)
        for k, v in kv.items():
            setattr(sub, k, v)
    for k, v in overrides.items():
        placed = False
        for sub in (cfg.model, cfg.data, cfg.train):
            if k in {f.name for f in dataclasses.fields(sub)}:
                setattr(sub, k, v)
                placed = True
                break
        if not placed:
            raise KeyError(f"unknown config field {k!r}")
    for k in ("compute_dtype", "table_dtype"):
        if getattr(cfg.model, k) not in DTYPES:
            raise ValueError(f"{k} must be one of {DTYPES}, got "
                             f"{getattr(cfg.model, k)!r}")
    return cfg
