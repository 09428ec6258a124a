"""Carry weights between the JAX package's flax parameter trees and the
port's modules (both ways), and the IVF quantizer state into the port.

Each function takes the nested flax param dict (``{"Conv_0": {"kernel":
...}, ...}``) with numpy (or array-like) leaves and loads it into a port
module. Layout conversions:

- conv kernel HWIO ``[kh, kw, in, out]`` -> OIHW ``[out, in, kh, kw]``;
- depthwise ``[3, 3, 1, C]`` -> ``[C, 1, 3, 3]`` and GDC ``[h, w, 1, C]``
  -> ``[C, 1, h, w]`` (the same permutation);
- Dense kernel ``[in, out]`` -> ``[out, in]``;
- GroupNorm scale and bias as they are.

The embedder's blocks are ``_SepBlock_i`` (full or light norm) or
``_DenseBlock_i``, each named as flax names it (``_embedder_blocks``).

``cascade_params_from_flax`` loads the stage-1 gate (``Conv_i`` /
``GroupNorm_i`` per block, the 1x1 head as the last ``Conv_*`` with its
bias).

``detector_params_to_flax``, ``embedder_params_to_flax`` and
``cascade_params_to_flax`` are the inverses: a port module's weights as
the flax tree (numpy float32), which the checkpoint writers store in the
JAX package's layout; a trained detector or gate goes back the same way.

``embedder_train_params_from_flax`` / ``embedder_train_params_to_flax``
carry the ArcFace trainer's ``{"net", "head"}`` params (the reference's
``init_embedder`` / ``train_embedder`` tree) both ways: the net's weights
into a port ``FaceEmbedNet``, the head [C, E] as a float32 tensor.

``ivf_data_from_numpy`` takes the reference's ``IVFDeviceData`` (its
arrays read back as numpy) to the port's, on a device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.parallel.quantizer import IVFDeviceData
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, resolve_device)

FlaxParams = Mapping[str, Any]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(p: FlaxParams) -> torch.Tensor:
    return _t(p["kernel"]).permute(3, 2, 0, 1).contiguous()


def _load(module: torch.nn.Module, state: Dict[str, torch.Tensor]) -> torch.nn.Module:
    dev = next(module.parameters()).device
    module.load_state_dict({k: v.to(dev) for k, v in state.items()})
    return module


def detector_params_from_flax(params: FlaxParams, net: torch.nn.Module) -> torch.nn.Module:
    """Load flax ``DetectorNet`` params into a port ``DetectorNet``:
    ``Conv_i``/``GroupNorm_i`` for the backbone, then the head conv and
    the heatmap/size/offset heads as the last four ``Conv_*``."""
    nb = len(net.convs)
    state: Dict[str, torch.Tensor] = {}
    for i in range(nb):
        state[f"convs.{i}.weight"] = _conv(params[f"Conv_{i}"])
        gn = params[f"GroupNorm_{i}"]
        state[f"norms.{i}.weight"] = _t(gn["scale"])
        state[f"norms.{i}.bias"] = _t(gn["bias"])
    for j, name in enumerate(("head", "heatmap", "size", "offset")):
        p = params[f"Conv_{nb + j}"]
        state[f"{name}.weight"] = _conv(p)
        state[f"{name}.bias"] = _t(p["bias"])
    return _load(net, state)


def _embedder_blocks(net: torch.nn.Module):
    """(flax name, port prefix, [(port param, flax module)]) of each block
    of a port ``FaceEmbedNet``: ``_SepBlock_i`` with ``Conv_0`` (depthwise),
    ``Conv_1`` (pointwise) and its norms (``GroupNorm_0`` and
    ``GroupNorm_1``, or the light block's one ``GroupNorm_0``), or
    ``_DenseBlock_i`` with ``Conv_0`` and ``GroupNorm_0``."""
    for i, blk in enumerate(net.blocks):
        if net.block == "dense":
            yield f"_DenseBlock_{i}", f"blocks.{i}", [("conv", "Conv_0"), ("gn", "GroupNorm_0")]
        elif blk.gn1 is not None:
            yield f"_SepBlock_{i}", f"blocks.{i}", [
                ("dw", "Conv_0"), ("pw", "Conv_1"), ("gn1", "GroupNorm_0"),
                ("gn2", "GroupNorm_1")]
        else:
            yield f"_SepBlock_{i}", f"blocks.{i}", [
                ("dw", "Conv_0"), ("pw", "Conv_1"), ("gn2", "GroupNorm_0")]


def embedder_params_from_flax(params: FlaxParams, net: torch.nn.Module) -> torch.nn.Module:
    """Load flax ``FaceEmbedNet`` params (``Conv_0``/``GroupNorm_0`` stem,
    ``_SepBlock_i`` or ``_DenseBlock_i`` blocks, ``Conv_1`` GDC,
    ``Dense_0`` head) into a port ``FaceEmbedNet`` of any variant."""
    state: Dict[str, torch.Tensor] = {
        "stem.weight": _conv(params["Conv_0"]),
        "stem_norm.weight": _t(params["GroupNorm_0"]["scale"]),
        "stem_norm.bias": _t(params["GroupNorm_0"]["bias"]),
        "gdc.weight": _conv(params["Conv_1"]),
        "dense.weight": _t(params["Dense_0"]["kernel"]).T.contiguous(),
        "dense.bias": _t(params["Dense_0"]["bias"]),
    }
    for flax_name, prefix, members in _embedder_blocks(net):
        p = params[flax_name]
        for attr, src in members:
            if src.startswith("Conv"):
                state[f"{prefix}.{attr}.weight"] = _conv(p[src])
            else:
                state[f"{prefix}.{attr}.weight"] = _t(p[src]["scale"])
                state[f"{prefix}.{attr}.bias"] = _t(p[src]["bias"])
    return _load(net, state)


def embedder_train_params_from_flax(params: FlaxParams,
                                    net: torch.nn.Module) -> torch.Tensor:
    """Load the reference's ``{"net": flax tree, "head": [C, E]}`` into
    ``net``; returns the head as a float32 tensor on the net's device."""
    embedder_params_from_flax(params["net"], net)
    return _t(params["head"]).to(next(net.parameters()).device)


def cascade_params_from_flax(params: FlaxParams, net: torch.nn.Module) -> torch.nn.Module:
    """Load flax ``CascadeNet`` params into a port ``CascadeNet``."""
    nb = len(net.convs)
    state: Dict[str, torch.Tensor] = {}
    for i in range(nb):
        state[f"convs.{i}.weight"] = _conv(params[f"Conv_{i}"])
        gn = params[f"GroupNorm_{i}"]
        state[f"norms.{i}.weight"] = _t(gn["scale"])
        state[f"norms.{i}.bias"] = _t(gn["bias"])
    head = params[f"Conv_{nb}"]
    state["head.weight"] = _conv(head)
    state["head.bias"] = _t(head["bias"])
    return _load(net, state)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def _hwio(w: torch.Tensor) -> np.ndarray:
    """OIHW -> HWIO (also the depthwise and GDC ``[C, 1, h, w]`` ->
    ``[h, w, 1, C]``)."""
    return _np(w.permute(2, 3, 1, 0))


def detector_params_to_flax(net: torch.nn.Module) -> Dict[str, Any]:
    """A port ``DetectorNet``'s weights as the flax ``DetectorNet`` tree."""
    nb = len(net.convs)
    tree: Dict[str, Any] = {}
    for i in range(nb):
        tree[f"Conv_{i}"] = {"kernel": _hwio(net.convs[i].weight)}
        tree[f"GroupNorm_{i}"] = {"scale": _np(net.norms[i].weight),
                                  "bias": _np(net.norms[i].bias)}
    for j, name in enumerate(("head", "heatmap", "size", "offset")):
        conv = getattr(net, name)
        tree[f"Conv_{nb + j}"] = {"kernel": _hwio(conv.weight), "bias": _np(conv.bias)}
    return tree


def cascade_params_to_flax(net: torch.nn.Module) -> Dict[str, Any]:
    """A port ``CascadeNet``'s weights as the flax ``CascadeNet`` tree."""
    nb = len(net.convs)
    tree: Dict[str, Any] = {}
    for i in range(nb):
        tree[f"Conv_{i}"] = {"kernel": _hwio(net.convs[i].weight)}
        tree[f"GroupNorm_{i}"] = {"scale": _np(net.norms[i].weight),
                                  "bias": _np(net.norms[i].bias)}
    tree[f"Conv_{nb}"] = {"kernel": _hwio(net.head.weight), "bias": _np(net.head.bias)}
    return tree


def embedder_params_to_flax(net: torch.nn.Module) -> Dict[str, Any]:
    """A port ``FaceEmbedNet``'s weights as the flax ``FaceEmbedNet`` tree."""
    tree: Dict[str, Any] = {
        "Conv_0": {"kernel": _hwio(net.stem.weight)},
        "GroupNorm_0": {"scale": _np(net.stem_norm.weight), "bias": _np(net.stem_norm.bias)},
        "Conv_1": {"kernel": _hwio(net.gdc.weight)},
        "Dense_0": {"kernel": _np(net.dense.weight.T), "bias": _np(net.dense.bias)},
    }
    for (flax_name, _prefix, members), blk in zip(_embedder_blocks(net), net.blocks):
        node = tree[flax_name] = {}
        for attr, dst in members:
            mod = getattr(blk, attr)
            node[dst] = ({"kernel": _hwio(mod.weight)} if dst.startswith("Conv")
                         else {"scale": _np(mod.weight), "bias": _np(mod.bias)})
    return tree


def embedder_train_params_to_flax(net: torch.nn.Module, head: torch.Tensor) -> Dict[str, Any]:
    """A port ``FaceEmbedNet`` and its ArcFace head as the reference's
    ``{"net": flax tree, "head": [C, E]}`` (numpy float32)."""
    return {"net": embedder_params_to_flax(net), "head": _np(head)}


#: dtypes of IVFDeviceData's seven arrays, in field order
_IVF_DTYPES = (np.float32, np.int32, np.int8, np.float32, np.int32, np.int8, np.float32)


def ivf_data_from_numpy(ivf, device: DeviceLike = DEFAULT_DEVICE) -> IVFDeviceData:
    """The JAX package's ``IVFDeviceData`` (or any tuple of its seven
    arrays, then optionally ``gallery_epoch``), as array-likes, as the
    port's ``IVFDeviceData`` on ``device``, values unchanged."""
    dev = resolve_device(device)
    fields = tuple(ivf)
    arrays = (torch.from_numpy(np.array(a, dtype=dt)).to(dev)
              for a, dt in zip(fields[:7], _IVF_DTYPES))
    epoch = int(fields[7]) if len(fields) > 7 else 0
    return IVFDeviceData(*arrays, gallery_epoch=epoch)
