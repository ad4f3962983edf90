"""Model-side core of the port: metatree, meta-partitioning, the relation-module IR, HGNN init and the SPMD plan."""
