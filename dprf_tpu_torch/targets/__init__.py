"""Target-list structures of the port: the blocked-Bloom probe table
(probe.py) and the bulk ingest of a target file (store.py)."""

from dprf_tpu_torch.targets.store import TargetStore

__all__ = ["TargetStore"]
