"""Convert data sources into packed shard files.

Counterpart of ``sparknet_tpu/tools/pack_records.py`` (``sparknet-pack``):
reads a source through the port's loaders and writes a packed dataset
directory, ``train/`` and ``test/`` of CRC-checked shard files with
index footers, each with a ``MANIFEST.json`` carrying the content
fingerprint the decoded-batch cache keys on, and for CIFAR-10 the
per-pixel ``mean.npy`` the apps' ``transform_param`` falls back to::

    python -m sparknet_tpu_torch.tools.pack_records --source synthetic-cifar \\
        --n 10000 --out /tmp/packed
    python -m sparknet_tpu_torch.tools.pack_records --source synthetic-imagenet \\
        --n 2048 --out /tmp/packed_imagenet

Shards mirror the source's partitions one to one (``--parts`` for the
CIFAR-10 sources), so the packed stream is the in-memory feed's, bit
for bit, and the packs are the JAX tool's, byte for byte. ``--source
lmdb`` (Caffe's LMDB) is not ported and raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..data.records import pack_dataset


def _pack_split(ds, out_dir, mean=None, meta=None):
    t0 = time.time()  # one-shot CLI wall time, not a metric
    manifest = pack_dataset(ds, out_dir, mean=mean, meta=meta)
    return {
        "dir": out_dir,
        "records": manifest["record_count"],
        "shards": len(manifest["shards"]),
        "bytes": sum(s["bytes"] for s in manifest["shards"]),
        "fingerprint": manifest["fingerprint"],
        "seconds": round(time.time() - t0, 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pack_records",
        description="convert cifar/imagenet/synthetic sources into the packed "
                    "sharded record format")
    ap.add_argument("--source", required=True,
                    choices=("cifar", "synthetic-cifar", "imagenet", "synthetic-imagenet",
                             "lmdb"),
                    help="lmdb is not ported")
    ap.add_argument("--data-dir", default=None,
                    help="source location (the cifar layouts, imagenet npz shards); "
                         "synthetic sources ignore it")
    ap.add_argument("--out", required=True, help="output dataset dir")
    ap.add_argument("--parts", type=int, default=8,
                    help="partitions -> shards for the CIFAR-10 sources (default 8, "
                         "the apps' loaders': keep it for the legacy stream)")
    ap.add_argument("--n", type=int, default=10000,
                    help="synthetic sources: training record count (the test "
                         "split's size follows the loaders' rules)")
    args = ap.parse_args(argv)

    src = args.source
    if src == "lmdb":
        raise NotImplementedError("--source lmdb: reading Caffe's LMDB is not ported to "
                                  "sparknet_tpu_torch yet")
    data_dir = None if src.startswith("synthetic") else args.data_dir
    meta = {"source": src, "packed_at": int(time.time())}
    out = []
    if src in ("cifar", "synthetic-cifar"):
        from ..data.cifar import cifar10_dataset

        train_ds, mean = cifar10_dataset(data_dir, train=True, num_partitions=args.parts,
                                         synthetic_n=args.n)
        test_ds, _ = cifar10_dataset(data_dir, train=False, num_partitions=args.parts,
                                     synthetic_n=args.n)
        out.append(_pack_split(train_ds, os.path.join(args.out, "train"), mean=mean,
                               meta=meta))
        out.append(_pack_split(test_ds, os.path.join(args.out, "test"), mean=mean,
                               meta=meta))
    else:
        from ..data.imagenet import imagenet_dataset

        train_ds = imagenet_dataset(data_dir, train=True, synthetic_n=args.n)
        test_ds = imagenet_dataset(data_dir, train=False, synthetic_n=args.n)
        out.append(_pack_split(train_ds, os.path.join(args.out, "train"), meta=meta))
        out.append(_pack_split(test_ds, os.path.join(args.out, "test"), meta=meta))
    print(json.dumps({"packed": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
