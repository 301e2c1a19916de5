"""Target-list structures of the port (the blocked-Bloom probe)."""
