"""Carry weights from the JAX package's flax parameter trees, and its IVF
quantizer state, into the port's modules.

Each function takes the nested flax param dict (``{"Conv_0": {"kernel":
...}, ...}``) with numpy (or array-like) leaves and loads it into a port
module. Layout conversions:

- conv kernel HWIO ``[kh, kw, in, out]`` -> OIHW ``[out, in, kh, kw]``;
- depthwise ``[3, 3, 1, C]`` -> ``[C, 1, 3, 3]`` and GDC ``[h, w, 1, C]``
  -> ``[C, 1, h, w]`` (the same permutation);
- Dense kernel ``[in, out]`` -> ``[out, in]``;
- GroupNorm scale and bias as they are.

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


def embedder_params_from_flax(params: FlaxParams, net: torch.nn.Module) -> torch.nn.Module:
    """Load flax ``FaceEmbedNet`` params (``Conv_0``/``GroupNorm_0`` stem,
    ``_SepBlock_i`` blocks, ``Conv_1`` GDC, ``Dense_0`` head) into a port
    ``FaceEmbedNet``."""
    state: Dict[str, torch.Tensor] = {
        "stem.weight": _conv(params["Conv_0"]),
        "stem_norm.weight": _t(params["GroupNorm_0"]["scale"]),
        "stem_norm.bias": _t(params["GroupNorm_0"]["bias"]),
        "gdc.weight": _conv(params["Conv_1"]),
        "dense.weight": _t(params["Dense_0"]["kernel"]).T.contiguous(),
        "dense.bias": _t(params["Dense_0"]["bias"]),
    }
    for i in range(len(net.blocks)):
        p = params[f"_SepBlock_{i}"]
        state[f"blocks.{i}.dw.weight"] = _conv(p["Conv_0"])
        state[f"blocks.{i}.pw.weight"] = _conv(p["Conv_1"])
        for gn, src in (("gn1", "GroupNorm_0"), ("gn2", "GroupNorm_1")):
            state[f"blocks.{i}.{gn}.weight"] = _t(p[src]["scale"])
            state[f"blocks.{i}.{gn}.bias"] = _t(p[src]["bias"])
    return _load(net, state)


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
