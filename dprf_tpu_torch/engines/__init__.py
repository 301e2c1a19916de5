"""Engine registry: (name, device) -> HashEngine class.

Engines self-register at import time via the @register decorator.
Devices: "cpu" (the hashlib oracles) and "cuda" (the torch engines;
their tensors live on a CUDA card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Dict, Tuple

from dprf_tpu_torch.engines.base import (DeviceHashEngine,  # noqa: F401
                                         HashEngine, Target)

_REGISTRY: Dict[Tuple[str, str], type] = {}

DEVICES = ("cpu", "cuda")


def register(name: str, device: str = "cpu"):
    def deco(cls):
        key = (name.lower(), device)
        if key in _REGISTRY and _REGISTRY[key] is not cls:
            raise ValueError(f"duplicate engine registration: {key}")
        _REGISTRY[key] = cls
        return cls
    return deco


def get_engine(name: str, device: str = "cpu", **kwargs):
    _ensure_imported(device)
    key = (name.lower(), device)
    if key not in _REGISTRY:
        have = sorted(n for n, d in _REGISTRY if d == device)
        raise KeyError(f"no engine {name!r} for device {device!r}; "
                       f"available: {have}")
    return _REGISTRY[key](**kwargs)


def engine_names(device: str = "cpu") -> list[str]:
    _ensure_imported(device)
    return sorted(n for n, d in _REGISTRY if d == device)


def engine_class(name: str, device: str = "cpu") -> type:
    """The registered class without instantiating it (for listings)."""
    _ensure_imported(device)
    return _REGISTRY[(name.lower(), device)]


def _ensure_imported(device: str) -> None:
    # Engine modules import lazily so the CPU oracle path never pulls
    # in torch.
    if device == "cpu":
        import dprf_tpu_torch.engines.cpu.engines  # noqa: F401
        import dprf_tpu_torch.engines.cpu.krb5  # noqa: F401
        import dprf_tpu_torch.engines.cpu.krb5aes  # noqa: F401
        import dprf_tpu_torch.engines.cpu.pdf  # noqa: F401
        import dprf_tpu_torch.engines.cpu.sevenzip  # noqa: F401
    elif device == "cuda":
        import dprf_tpu_torch.engines.device.bcrypt  # noqa: F401
        import dprf_tpu_torch.engines.device.engines  # noqa: F401
        import dprf_tpu_torch.engines.device.krb5  # noqa: F401
        import dprf_tpu_torch.engines.device.krb5aes  # noqa: F401
        import dprf_tpu_torch.engines.device.nested  # noqa: F401
        import dprf_tpu_torch.engines.device.pdf  # noqa: F401
        import dprf_tpu_torch.engines.device.pmkid  # noqa: F401
        import dprf_tpu_torch.engines.device.salted  # noqa: F401
        import dprf_tpu_torch.engines.device.sevenzip  # noqa: F401
        import dprf_tpu_torch.engines.device.sha3  # noqa: F401
    else:
        raise KeyError(f"unknown device {device!r} "
                       f"(expected one of {DEVICES})")
