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
    python -m sparknet_tpu_torch.tools.pack_records --source lmdb \\
        --data-dir train_lmdb --out /tmp/packed_lmdb

Shards mirror the source's partitions one to one (``--parts`` for the
CIFAR-10 and LMDB sources), so the packed stream is the in-memory
feed's, bit for bit, and the packs are the JAX tool's, byte for byte.
An LMDB (Caffe's ``Data`` layer source, read by
:func:`~..data.caffe_layers.lmdb_dataset`) is one split: ``train/``.
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
        description="convert cifar/imagenet/lmdb/synthetic sources into the "
                    "packed sharded record format")
    ap.add_argument("--source", required=True,
                    choices=("cifar", "synthetic-cifar", "imagenet", "synthetic-imagenet",
                             "lmdb"))
    ap.add_argument("--data-dir", default=None,
                    help="source location (the cifar layouts, the imagenet layouts, or "
                         "an LMDB dir or file); synthetic sources ignore it")
    ap.add_argument("--out", required=True, help="output dataset dir")
    ap.add_argument("--parts", type=int, default=8,
                    help="partitions -> shards for the CIFAR-10 and LMDB sources (default 8, "
                         "the apps' loaders': keep it for the legacy stream)")
    ap.add_argument("--n", type=int, default=10000,
                    help="synthetic sources: training record count (the test "
                         "split's size follows the loaders' rules)")
    args = ap.parse_args(argv)

    src = args.source
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
    elif src in ("imagenet", "synthetic-imagenet"):
        from ..data.imagenet import imagenet_dataset

        train_ds = imagenet_dataset(data_dir, train=True, synthetic_n=args.n)
        test_ds = imagenet_dataset(data_dir, train=False, synthetic_n=args.n)
        out.append(_pack_split(train_ds, os.path.join(args.out, "train"), meta=meta))
        out.append(_pack_split(test_ds, os.path.join(args.out, "test"), meta=meta))
    else:  # lmdb: one DB is one split
        if not args.data_dir:
            ap.error("--source lmdb requires --data-dir")
        from ..data.caffe_layers import lmdb_dataset

        ds = lmdb_dataset(args.data_dir, num_partitions=args.parts)
        out.append(_pack_split(ds, os.path.join(args.out, "train"), meta=meta))
    print(json.dumps({"packed": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
