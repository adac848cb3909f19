"""Shared plumbing of the evaluation tools (``caffe test``): the net of a
phase over its prototxt's own on-disk data source, and trained weights
laid over its init.

Counterpart of ``sparknet_tpu/tools/_common.py``."""

from __future__ import annotations

import numpy as np

# (net, params, state, "a.caffemodel,b.solverstate.npz") -> (params, state),
# later files winning, as the caffe binary's CopyTrainedLayersFrom
from ..nets.weights import load_weights_any as load_weights  # noqa: F401

DATA_SOURCE_TYPES = ("Data", "ImageData", "HDF5Data")


def find_data_layer(net_param, phase: str):
    """The phase's first data layer with an on-disk source, or None."""
    return next((l for l in net_param.layers_for_phase(phase)
                 if l.type in DATA_SOURCE_TYPES), None)


def build_phase_net(net_param, model_dir: str, phase: str, device="cuda"):
    """(net, dataset, transformer, batch_size) of a phase, from the net's
    own data layer: its batch size and transform_param as training takes
    them; a missing ``mean_file`` is regenerated from the TRAIN source
    (what training subtracted), collapsed to the per-channel mean when the
    TRAIN source's resolution differs. (None, None, None, 0) when the
    source is not on disk."""
    from ..apps.cifar_app import _batch_size, _dataset_mean, make_transformer, source_data_shape
    from ..data.caffe_layers import dataset_from_layer
    from ..nets.torchnet import TorchNet

    data_layer = find_data_layer(net_param, phase)
    ds = dataset_from_layer(data_layer, model_dir)
    if ds is None:
        return None, None, None, 0
    bs = _batch_size(data_layer, 32)

    def regenerated_mean():
        mean_ds = dataset_from_layer(find_data_layer(net_param, "TRAIN"), model_dir)
        src = mean_ds if mean_ds is not None else ds
        m = _dataset_mean(src)
        if src is not ds and m.ndim == 3 and tuple(m.shape[:2]) != tuple(ds.sample_shape()[:2]):
            m = m.mean((0, 1))
        return m

    tf = make_transformer(data_layer, phase == "TRAIN", model_dir, regenerated_mean)
    h, w, c = source_data_shape(ds, tf.crop_size, True, None)
    net = TorchNet(net_param, phase, {"data": (bs, h, w, c), "label": (bs,)}, device=device)
    return net, ds, tf, bs


def batch_transform_fn(tf):
    """The host-side transform of each batch the eval tools feed."""

    def transform(batch, rng):
        return {"data": np.asarray(tf(batch["data"], rng), np.float32),
                "label": np.asarray(batch["label"], np.int32)}

    return transform
