"""Precompute training or validation chunks of a ScanNet-layout store.

Usage::

    python -m pointcloud_segmentation_attention_tpu_torch.data.scannet.precompute_cli \\
        --data_root /data/scannet --out_dir /data/chunks --epochs 80 \\
        [--split train|val] [--npoints 8192] [--start_epoch K] [--subset] \\
        [--num_hosts H --host_id I]
"""
from __future__ import annotations

import argparse

from pointcloud_segmentation_attention_tpu_torch.data.scannet import precompute, scenes


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--split", default="train", choices=["train", "val"])
    p.add_argument("--epochs", type=int, default=80, help="train chunk epochs to precompute")
    p.add_argument("--start_epoch", type=int, default=0,
                   help="resume an interrupted precompute job")
    p.add_argument("--npoints", type=int, default=8192)
    p.add_argument("--subset", action="store_true",
                   help="the first third of the scene list")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_hosts", type=int, default=1,
                   help="shard the scene list across hosts (round-robin)")
    p.add_argument("--host_id", type=int, default=0)
    args = p.parse_args(argv)

    names = scenes.read_split(f"{args.data_root}/splits", args.split)
    if args.subset:
        names = names[: len(names) // 3]
    if args.num_hosts > 1:
        names = names[args.host_id::args.num_hosts]
    if args.split == "train":
        n = precompute.precompute_train_chunks(
            args.data_root, names, args.out_dir, args.epochs, npoints=args.npoints,
            start_epoch=args.start_epoch, seed=args.seed)
    else:
        n = precompute.precompute_val_chunks(args.data_root, names, args.out_dir,
                                             npoints=args.npoints, seed=args.seed)
    print(f"wrote {n} chunks to {args.out_dir}")


if __name__ == "__main__":
    main()
