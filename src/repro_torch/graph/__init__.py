"""Heterogeneous graph containers, synthetic datasets and the metatree sampler (numpy)."""
