"""Synthetic HetG generators mirroring the paper's datasets (Table 1).

The container is offline, so instead of downloading ogbn-mag / Freebase /
Donor / IGB-HET / MAG240M we generate random heterogeneous graphs with the
*same schema* (node types, relations incl. reverses, feature-dimension
profile, target type, class count) and a ``scale`` knob that multiplies node
counts.  Degree distributions are skewed (Zipf-like) to reproduce the hot-node
phenomenon the cache relies on (paper §6).

At ``scale=1.0`` the generators produce laptop-sized graphs; benchmarks that
report paper-scale numbers use the generators' *statistics* analytically.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graph.hetgraph import CSR, HetGraph, Relation, reverse_relation

__all__ = [
    "ogbn_mag_like",
    "freebase_like",
    "donor_like",
    "igb_het_like",
    "mag240m_like",
    "mag240m_stream",
    "DATASETS",
    "make_dataset",
]


def _zipf_ids(rng: np.random.Generator, n_ids: int, n_samples: int, a: float = 1.2):
    """Sample node ids with a Zipf-ish popularity skew (stable hot set)."""
    # ranks ~ Zipf; map rank -> id through a fixed permutation so hot ids are
    # spread over the id space (matches real datasets; defeats trivial caching)
    ranks = rng.zipf(a, size=n_samples)
    ranks = np.minimum(ranks - 1, n_ids - 1)
    perm = np.random.default_rng(12345).permutation(n_ids)  # fixed, per-graph
    return perm[ranks]


def _rand_relation(
    rng: np.random.Generator,
    num_src: int,
    num_dst: int,
    num_edges: int,
    skew_src: bool = True,
) -> CSR:
    src = (
        _zipf_ids(rng, num_src, num_edges)
        if skew_src
        else rng.integers(0, num_src, num_edges)
    )
    dst = rng.integers(0, num_dst, num_edges)
    return CSR.from_edges(src, dst, num_dst)


def _features(rng, n, dim, dtype=np.float32):
    return (rng.standard_normal((n, dim)) * 0.1).astype(dtype)


def _add_reverse(
    relations: Dict[Relation, CSR], num_nodes: Dict[str, int], skip: Sequence[str] = ()
) -> Dict[Relation, CSR]:
    out = dict(relations)
    for rel, csr in relations.items():
        if rel.etype in skip:
            continue
        rrel = reverse_relation(rel)
        s, d = csr.edges()
        out[rrel] = CSR.from_edges(d, s, num_nodes[rrel.dst])
    return out


# --------------------------------------------------------------------------
# ogbn-mag: 4 node types, 4 relations + 3 reverses, only "paper" featured
# --------------------------------------------------------------------------


def ogbn_mag_like(scale: float = 0.01, seed: int = 0, feat_dim: int = 128) -> HetGraph:
    rng = np.random.default_rng(seed)
    n = {
        "paper": max(int(736_389 * scale), 64),
        "author": max(int(1_134_649 * scale), 64),
        "institution": max(int(8_740 * scale), 8),
        "field_of_study": max(int(59_965 * scale), 16),
    }
    e = lambda x: max(int(x * scale), 256)
    base = {
        Relation("author", "writes", "paper"): _rand_relation(
            rng, n["author"], n["paper"], e(7_145_660)
        ),
        Relation("paper", "cites", "paper"): _rand_relation(
            rng, n["paper"], n["paper"], e(5_416_271)
        ),
        Relation("paper", "has_topic", "field_of_study"): _rand_relation(
            rng, n["paper"], n["field_of_study"], e(7_505_078)
        ),
        Relation("author", "affiliated_with", "institution"): _rand_relation(
            rng, n["author"], n["institution"], e(1_043_998)
        ),
    }
    # paper: 4 relations + 3 reverses (no reverse for cites) = 7 edge types
    relations = _add_reverse(base, n, skip=("cites",))
    return HetGraph(
        num_nodes=n,
        relations=relations,
        target_type="paper",
        num_classes=349,
        features={"paper": _features(rng, n["paper"], feat_dim)},
        name="ogbn-mag-like",
    )


# --------------------------------------------------------------------------
# Freebase: 8 node types, 64 edge types, NO features (all learnable)
# --------------------------------------------------------------------------


def freebase_like(scale: float = 0.002, seed: int = 1) -> HetGraph:
    rng = np.random.default_rng(seed)
    types = ["book", "film", "music", "sports", "people", "location", "org", "business"]
    n = {t: max(int(1_500_000 * scale * w), 64) for t, w in zip(types, [1.2, 0.9, 1.5, 0.4, 2.0, 0.8, 0.7, 0.5])}
    relations: Dict[Relation, CSR] = {}
    # 32 base relations + 32 reverses = 64 edge types; ensure the target type
    # ("book") has several in-relations so the metatree has multiple children.
    pairs: List[Tuple[str, str]] = []
    for i, s in enumerate(types):
        for j in range(4):
            d = types[(i + j + 1) % len(types)]
            pairs.append((s, d))
    for k, (s, d) in enumerate(pairs):
        rel = Relation(s, f"r{k}", d)
        relations[rel] = _rand_relation(
            rng, n[s], n[d], max(int(4_000_000 * scale), 128)
        )
    relations = _add_reverse(relations, n)
    return HetGraph(
        num_nodes=n,
        relations=relations,
        target_type="book",
        num_classes=8,
        features={},  # featureless: learnable features everywhere
        name="freebase-like",
    )


# --------------------------------------------------------------------------
# Donor: 7 node types, ALL featured with wildly varying dims (7..789)
# --------------------------------------------------------------------------


def donor_like(scale: float = 0.003, seed: int = 2) -> HetGraph:
    rng = np.random.default_rng(seed)
    dims = {
        "project": 789,
        "school": 300,
        "teacher": 7,
        "donor": 28,
        "donation": 64,
        "resource": 128,
        "category": 16,
    }
    n = {
        "project": max(int(1_100_000 * scale), 64),
        "school": max(int(72_000 * scale), 32),
        "teacher": max(int(400_000 * scale), 32),
        "donor": max(int(2_000_000 * scale), 64),
        "donation": max(int(4_600_000 * scale), 64),
        "resource": max(int(1_500_000 * scale), 64),
        "category": max(int(51 * 1.0), 51),
    }
    base = {
        Relation("school", "hosts", "project"): _rand_relation(rng, n["school"], n["project"], max(int(1_100_000 * scale), 128)),
        Relation("teacher", "submits", "project"): _rand_relation(rng, n["teacher"], n["project"], max(int(1_100_000 * scale), 128)),
        Relation("donation", "funds", "project"): _rand_relation(rng, n["donation"], n["project"], max(int(4_600_000 * scale), 128)),
        Relation("donor", "gives", "donation"): _rand_relation(rng, n["donor"], n["donation"], max(int(4_600_000 * scale), 128)),
        Relation("resource", "requested_by", "project"): _rand_relation(rng, n["resource"], n["project"], max(int(7_200_000 * scale), 128)),
        Relation("category", "tags", "project"): _rand_relation(rng, n["category"], n["project"], max(int(2_200_000 * scale), 128)),
        Relation("category", "groups", "resource"): _rand_relation(rng, n["category"], n["resource"], max(int(1_500_000 * scale), 128)),
    }
    relations = _add_reverse(base, n)
    return HetGraph(
        num_nodes=n,
        relations=relations,
        target_type="project",
        num_classes=2,
        features={t: _features(rng, n[t], d) for t, d in dims.items()},
        name="donor-like",
    )


# --------------------------------------------------------------------------
# IGB-HET: 4 node types, all featured, uniform dim 1024, many classes
# --------------------------------------------------------------------------


def igb_het_like(scale: float = 0.001, seed: int = 3, feat_dim: int = 1024) -> HetGraph:
    rng = np.random.default_rng(seed)
    n = {
        "paper": max(int(10_000_000 * scale), 64),
        "author": max(int(12_000_000 * scale), 64),
        "institute": max(int(26_000 * scale), 16),
        "fos": max(int(190_000 * scale), 16),
    }
    base = {
        Relation("author", "written_by", "paper"): _rand_relation(rng, n["author"], n["paper"], max(int(190_000_000 * scale), 256)),
        Relation("paper", "cites", "paper"): _rand_relation(rng, n["paper"], n["paper"], max(int(120_000_000 * scale), 256)),
        Relation("paper", "topic", "fos"): _rand_relation(rng, n["paper"], n["fos"], max(int(100_000_000 * scale), 256)),
        Relation("author", "affiliated_to", "institute"): _rand_relation(rng, n["author"], n["institute"], max(int(48_000_000 * scale), 256)),
    }
    relations = _add_reverse(base, n, skip=("cites",))
    return HetGraph(
        num_nodes=n,
        relations=relations,
        target_type="paper",
        num_classes=2983,
        features={t: _features(rng, cnt, feat_dim) for t, cnt in n.items()},
        name="igb-het-like",
    )


# --------------------------------------------------------------------------
# MAG240M: 3 node types, 5 edge types, only "paper" featured (dim 768)
# --------------------------------------------------------------------------


def mag240m_like(scale: float = 0.0002, seed: int = 4, feat_dim: int = 768) -> HetGraph:
    rng = np.random.default_rng(seed)
    n = {
        "paper": max(int(121_000_000 * scale), 64),
        "author": max(int(122_000_000 * scale), 64),
        "institution": max(int(26_000 * scale), 16),
    }
    base = {
        Relation("author", "writes", "paper"): _rand_relation(rng, n["author"], n["paper"], max(int(386_000_000 * scale), 256)),
        Relation("paper", "cites", "paper"): _rand_relation(rng, n["paper"], n["paper"], max(int(1_300_000_000 * scale), 256)),
        Relation("author", "affiliated_with", "institution"): _rand_relation(rng, n["author"], n["institution"], max(int(44_000_000 * scale), 256)),
    }
    # 3 base + reverses of writes/affiliated_with = 5 edge types (Table 1)
    relations = _add_reverse(base, n, skip=("cites",))
    return HetGraph(
        num_nodes=n,
        relations=relations,
        target_type="paper",
        num_classes=153,
        features={"paper": _features(rng, n["paper"], feat_dim, np.float16)},
        name="mag240m-like",
    )


# --------------------------------------------------------------------------
# streaming mag240m: billion-edge-schema CSRs built chunk-wise to an mmap
# store, never materializing the edge payload in RAM (DESIGN.md §13)
# --------------------------------------------------------------------------


def _stream_chunks(seed: int, rel_id: int, num_src: int, num_dst: int,
                   num_edges: int, chunk: int, perm: np.ndarray,
                   a: float = 1.2):
    """Deterministic COO chunks of one base relation.

    Chunk ``c`` is a pure function of ``(seed, rel_id, c)`` so the two-pass
    counting sort can regenerate the identical stream on each pass — the
    out-of-core analog of :func:`_rand_relation` (same Zipf-skewed sources
    through a fixed id permutation, uniform destinations)."""
    for c, start in enumerate(range(0, num_edges, chunk)):
        m = min(chunk, num_edges - start)
        rng = np.random.default_rng([seed, rel_id, c])
        ranks = np.minimum(rng.zipf(a, size=m) - 1, num_src - 1)
        src = perm[ranks]
        dst = rng.integers(0, num_dst, m)
        yield src, dst


def _stream_fill_csr(writer, rel_index: int, chunks, num_dst: int) -> None:
    """Two-pass chunked counting sort straight into the store's memmap views.

    Pass 1 accumulates per-destination degrees (O(num_dst) RAM) and cumsums
    them into ``indptr``; pass 2 regenerates the same chunks and scatters
    source ids to their final slots via per-destination write cursors.  The
    O(num_edges) ``indices`` array only ever exists on disk — this replaces
    the global ``argsort`` of :meth:`CSR.from_edges`, whose COO + order
    arrays would need ~3x the edge payload in RAM."""
    indptr = writer.array(f"rel/{rel_index}/indptr")
    indices = writer.array(f"rel/{rel_index}/indices")
    counts = np.zeros(num_dst, dtype=np.int64)
    for _, d in chunks():
        counts += np.bincount(d, minlength=num_dst)
    indptr[0] = 0
    np.cumsum(counts, out=indptr[1:])
    cursor = indptr[:-1].copy()
    for s, d in chunks():
        order = np.argsort(d, kind="stable")
        ds, ss = d[order], s[order]
        uniq, first, cnt = np.unique(ds, return_index=True,
                                     return_counts=True)
        offs = np.arange(ds.size, dtype=np.int64) - np.repeat(first, cnt)
        indices[cursor[ds] + offs] = ss
        cursor[uniq] += cnt


def mag240m_stream(scale: float = 0.005, seed: int = 4, feat_dim: int = 768,
                   chunk_edges: int = 1 << 20, include_features: bool = True,
                   root: Optional[str] = None):
    """MAG240M-schema graph built chunk-wise into an mmap store.

    Same schema as :func:`mag240m_like` (3 base relations + reverses of
    writes/affiliated_with, paper-featured, 153 classes) but constructed
    out-of-core: every CSR is filled by :func:`_stream_fill_csr` in
    ``chunk_edges``-sized pieces, so at ``scale=1.0`` the ~1.7B-edge
    topology (and the feature table) land directly in the store's
    ``data.bin`` while peak RAM stays O(nodes + chunk).  Deterministic in
    ``(seed, chunk_edges)`` — each chunk's RNG is keyed by its index, so
    the two passes replay identically; a different chunking draws a
    different (equally valid) graph.  Returns the owning
    :class:`~repro_torch.graph.mmap_store.MmapHetGraph`; attach it (or hand its
    picklable handle to trainer processes) via
    :func:`~repro_torch.graph.mmap_store.attach_mmap`.
    """
    from repro_torch.graph.mmap_store import create_store_writer

    n = {
        "paper": max(int(121_000_000 * scale), 64),
        "author": max(int(122_000_000 * scale), 64),
        "institution": max(int(26_000 * scale), 16),
    }
    # base streams: (rel_id, src_type, dst_type, num_edges)
    base = {
        "writes": (0, "author", "paper", max(int(386_000_000 * scale), 256)),
        "cites": (1, "paper", "paper", max(int(1_300_000_000 * scale), 256)),
        "affiliated_with": (
            2, "author", "institution", max(int(44_000_000 * scale), 256)),
    }
    rels = {
        Relation("author", "writes", "paper"): ("writes", False),
        Relation("paper", "cites", "paper"): ("cites", False),
        Relation("author", "affiliated_with", "institution"): (
            "affiliated_with", False),
        Relation("paper", "rev_writes", "author"): ("writes", True),
        Relation("institution", "rev_affiliated_with", "author"): (
            "affiliated_with", True),
    }
    rel_order = sorted(rels)  # handle order matches mmap_share_graph's

    spec: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for i, rel in enumerate(rel_order):
        ename, _ = rels[rel]
        _, _, _, ne = base[ename]
        spec[f"rel/{i}/indptr"] = ((n[rel.dst] + 1,), "<i8")
        spec[f"rel/{i}/indices"] = ((ne,), "<i8")
    spec["labels"] = ((n["paper"],), "<i8")
    spec["train_nodes"] = ((n["paper"],), "<i8")
    if include_features:
        spec["feat/paper"] = ((n["paper"], feat_dim), "<f2")

    writer = create_store_writer(
        spec, num_nodes=n,
        relations=tuple((r.src, r.etype, r.dst) for r in rel_order),
        target_type="paper", num_classes=153, graph_name="mag240m-stream",
        root=root,
    )
    try:
        # hot-id permutations, one per base src type (matches _zipf_ids's
        # fixed per-graph permutation; O(nodes) RAM, reused across passes)
        perms = {
            t: np.random.default_rng(12345).permutation(n[t])
            for t in ("author", "paper")
        }
        for i, rel in enumerate(rel_order):
            ename, reverse = rels[rel]
            rel_id, src_t, dst_t, ne = base[ename]

            def chunks(_rid=rel_id, _s=src_t, _d=dst_t, _ne=ne, _rev=reverse):
                for s, d in _stream_chunks(seed, _rid, n[_s], n[_d], _ne,
                                           chunk_edges, perms[_s]):
                    yield (d, s) if _rev else (s, d)

            _stream_fill_csr(writer, i, chunks,
                             n[rel.dst])
        labels = writer.array("labels")
        train = writer.array("train_nodes")
        rng_rows = max(1, chunk_edges // max(feat_dim, 1))
        lab_rng = np.random.default_rng(0)  # matches HetGraph's auto labels
        labels[:] = lab_rng.integers(0, 153, n["paper"]).astype(np.int64)
        train[:] = np.arange(n["paper"], dtype=np.int64)
        if include_features:
            feat = writer.array("feat/paper")
            for start in range(0, n["paper"], rng_rows):
                stop = min(start + rng_rows, n["paper"])
                rng = np.random.default_rng([seed, 8, start])
                feat[start:stop] = (
                    rng.standard_normal((stop - start, feat_dim)) * 0.1
                ).astype(np.float16)
        return writer.commit()
    except BaseException:
        writer.abort()
        raise


DATASETS = {
    "ogbn-mag": ogbn_mag_like,
    "freebase": freebase_like,
    "donor": donor_like,
    "igb-het": igb_het_like,
    "mag240m": mag240m_like,
}


def make_dataset(name: str, scale: Optional[float] = None, seed: int = 0) -> HetGraph:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(DATASETS)}")
    kwargs = {"seed": seed}
    if scale is not None:
        kwargs["scale"] = scale
    return DATASETS[name](**kwargs)
