"""Carry state between the JAX reference and the port, through numpy.

* ``to_torch``: a numpy array (a JAX output after ``np.asarray``) into a
  tensor on a device; ``uint32`` (bitplanes) travels exactly, as an int32
  view of the same bits, and comes out as a ``torch.uint32`` view;
* ``to_numpy``: a tensor back to numpy, ``uint32`` included;
* ``codec_config``: a port ``BlockCodecConfig`` from any object with the
  reference config's fields (``bits``, ``block``, ``delta``).

Nothing here imports JAX: the caller hands over numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.blockcodec import BlockCodecConfig


def to_torch(a, device: str | torch.device = "cuda") -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX buffers are read-only
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device).view(torch.uint32)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def codec_config(cfg) -> BlockCodecConfig:
    return BlockCodecConfig(bits=int(cfg.bits), block=int(cfg.block),
                            delta=bool(cfg.delta))
