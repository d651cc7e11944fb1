"""Trainer configuration: a dataclass, JSON and command-line overrides.

The port's own copy of the JAX package's ``utils/config.py``: the same
fields, defaults and JSON, so a ``config.json`` written by either package
loads in the other.  The device is not a field: it is a keyword of
``train.trainer.train`` and ``make_eval_state`` and the ``--device`` flag of
``train.trainer.main``.  Fields of paths the port does not run yet
(``input='resident'|'sampler'``, ``device_replay``, ``compute_dtype=
'bfloat16'``, ``remat``, ``n_devices`` > 1) are kept so such configs load;
``train`` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass
class TrainConfig:
    # data
    data_root: str = "data/scannet"
    split_dir: str = ""            # defaults to <data_root>/splits
    precompute_dir: str = ""       # defaults to <data_root>/precomputed
    n_points: int = 8192
    use_colors: bool = True
    use_normals: bool = True
    use_subset: bool = False       # the first third of the train scenes
    # Chunk geometry of the sampler mode and the on-the-fly val chunker
    # (precomputed corpora keep the geometry they were cut with).
    chunk_size: float = 1.5
    context_margin: float = 0.2
    # Input path:
    #   'npz'      — replay precomputed npz chunks (data/scannet/precompute.py),
    #   'packed'   — replay the packed-record store, one u8 buffer per batch
    #                (data/scannet/packstore.py, data/wire.py),
    #   'resident' — the packed corpus resident on the device (not ported),
    #   'sampler'  — raw scenes on the device, chunks cut there (not ported),
    #   'auto'     — derived from wire_format and device_replay.
    input: str = "auto"
    # 'f32', 'compact' (u8 labels/mask/colors, f16 normals, widened on the
    # device) or a packed format: 'packed', 'packed_q16', optionally with an
    # 'xK' suffix that splits the buffer into K byte-column slices.
    wire_format: str = "f32"
    # The packed corpus resident on the device, and its budget (not ported).
    device_replay: bool = False
    device_replay_budget_mb: int = 4096
    # The sampler mode's budget for the resident raw scenes, its val-chunk
    # cache and its per-step rotation (not ported).
    sampler_budget_mb: int = 8192
    cache_val_chunks: bool = True
    resident_augment: bool = False
    # model
    model: str = "sem_seg_features"
    num_classes: int = 21
    attention_single_layer: int = -1
    compute_dtype: str = "float32"  # 'bfloat16' is not ported
    # Extra keyword arguments of the model (e.g. sa_npoints / sa_mlps
    # hierarchies, dropout_rate); a JSON dict.
    model_overrides: Optional[dict] = None
    # Activation rematerialisation: only 'none' is ported.
    remat: str = "none"
    # training
    epochs: int = 500
    batch_size: int = 16
    base_lr: float = 1e-3
    n_epochs_to_val: int = 4
    seed: int = 0
    resume: bool = False           # restore the latest checkpoint and continue
    save_every_epochs: int = 10    # periodic checkpoint every this many epochs
    # io
    log_dir: str = "logs"
    ckpt_dir: str = ""             # defaults to <log_dir>/checkpoints
    # parallelism: None or 1 (one device)
    n_devices: Optional[int] = None

    def __post_init__(self):
        if not self.split_dir:
            self.split_dir = f"{self.data_root}/splits"
        if not self.precompute_dir:
            self.precompute_dir = f"{self.data_root}/precomputed"
        if not self.ckpt_dir:
            self.ckpt_dir = f"{self.log_dir}/checkpoints"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TrainConfig":
        return cls(**json.loads(text))

    @classmethod
    def from_args(cls, argv=None) -> "TrainConfig":
        parser = argparse.ArgumentParser(description="ScanNet trainer")
        parser.add_argument("--config", type=str, default=None,
                            help="JSON config file to start from")
        # Every flag defaults to SUPPRESS so the parsed namespace contains
        # ONLY explicitly-passed flags — CLI overrides the config file, and
        # the config file overrides the dataclass defaults (never the other
        # way around).
        for f in dataclasses.fields(cls):
            if f.type in (bool, "bool"):
                parser.add_argument(
                    f"--{f.name}",
                    type=lambda s: s.lower() in ("1", "true", "yes"),
                    default=argparse.SUPPRESS,
                )
            elif f.type in (int, "int") or f.name == "n_devices":
                parser.add_argument(f"--{f.name}", type=int,
                                    default=argparse.SUPPRESS)
            elif f.type in (float, "float"):
                parser.add_argument(f"--{f.name}", type=float,
                                    default=argparse.SUPPRESS)
            else:
                parser.add_argument(f"--{f.name}", type=str,
                                    default=argparse.SUPPRESS)
        args = vars(parser.parse_args(argv))
        config_path = args.pop("config", None)
        base = {}
        if config_path:
            with open(config_path) as fh:
                base = json.load(fh)
        base.update(args)
        # drop empty-string values so __post_init__ derives them
        for k in ("split_dir", "precompute_dir", "ckpt_dir"):
            if not base.get(k):
                base.pop(k, None)
        if isinstance(base.get("model_overrides"), str):
            base["model_overrides"] = json.loads(base["model_overrides"])
        return cls(**base)
