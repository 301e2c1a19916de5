"""The device mesh of the sharded runtime: a list of torch devices, one
keyspace shard each -- the counterpart of the reference's
parallel/mesh.py, whose 1-D ``candidates`` mesh is one process over a
list of devices.

The port's mesh is that list, run by one process (parallel/sharded.py
enqueues every shard's launches on its own device's current stream, so
the cards compute at once).  A list may repeat a device: the tests run
8 shards on the CPU, the counterpart of the reference's 8 virtual CPU
devices, and ``chip_smoke.py`` runs 4 shards on one card.  A mesh
across hosts (the reference's ``init_multihost``) waits for the serve
plane.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> list:
    """The first ``n_devices`` of ``devices`` (default: every card,
    ``cuda:0..N-1``) as torch devices; raises when more are asked for
    than the list holds."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if any(d.type == "cuda" and d.index is None for d in devices):
        raise ValueError("a mesh names each card by its index (cuda:N)")
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, only "
                             f"{len(devices)} present")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices
