"""Carry query state between numpy and the port's device tensors.

The reference keeps a query's store as a dict of JAX arrays
(``CompiledDeviceQuery.state``); ``jax.device_get`` turns it into numpy.
:func:`state_from_numpy` loads such a dict into the port (the counterpart
of carrying weights across), and :func:`state_to_numpy` reads the port's
state back.  Keys, shapes and dtypes are the same on both sides; a nested dict (a join
query's table store under ``jtab``) stays nested.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and there
    is no card — the port never carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ksql_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain torch versions of the kernels"
        )
    return dev


def state_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """Copy a state dict of numpy arrays (0-d for scalars) onto ``device``."""
    dev = resolve_device(device)
    return {
        k: state_from_numpy(v, dev) if isinstance(v, Mapping)
        else torch.from_numpy(np.array(v, copy=True)).to(dev)
        for k, v in arrays.items()
    }


def state_to_numpy(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copy a state dict of tensors to writable host numpy arrays."""
    return {
        k: state_to_numpy(v) if isinstance(v, Mapping) else v.detach().cpu().numpy().copy()
        for k, v in state.items()
    }
