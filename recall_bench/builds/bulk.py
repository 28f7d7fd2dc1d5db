"""Build the port's serving engine over the benchmark's corpus from the
port's own public pieces (``tools/e2e_engine.py``'s ``records``,
``aux_columns``, ``cluster_signatures`` and ``device_planes``;
``DeviceIndex.bulk_load`` and ``install_device_planes``): the host mirrors
are bulk-loaded, and the planes are made on the card from the corpus's
integer tables where the storage is int8; f32 storage takes the standard
upload of the host rows.

``build(config, corpus, device)`` returns the engine and ``answer(hits)``:
a served answer as (row numbers, scores), read from the DTO's chunk ids.
"""

from __future__ import annotations

from array import array


def build(config: dict, corpus, device):
    import torch

    from omni_recall_tpu_torch.config import EngineOptions
    from omni_recall_tpu_torch.index.device_index import EPOCH, to_micros
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.search.engine import RecallEngine
    from omni_recall_tpu_torch.tools import e2e_engine as e2e

    from recall_bench import reference

    if to_micros(EPOCH) != reference.EPOCH_US:
        raise AssertionError("the program's day 0 differs from the reference's")
    n = corpus.n
    opts = EngineOptions(**config["engine"])
    engine = RecallEngine(InMemoryIngestionStore(), options=opts, device=device)
    dix = engine.device_index
    sigs = e2e.cluster_signatures(corpus.contents, dix)
    meta = e2e.records(n, corpus.emb, corpus.assign, corpus.contents, corpus.created_days)
    aux = e2e.aux_columns(n, corpus.assign, corpus.contents, corpus.created_days)
    dix.bulk_load(corpus.emb, sigs[corpus.assign], corpus.created_days, meta, aux=aux)
    if dix.scan_dtype == "int8":
        planes = e2e.device_planes(dix, n, corpus.center8, corpus.noise8, corpus.scale, sigs,
                                   corpus.assign, corpus.slab_rows, dix.exact_cos)
        dix.install_device_planes(planes)
    else:
        dix.device_arrays()
    if dix.device.type == "cuda":
        torch.cuda.synchronize(dix.device)
    return engine, answer


def answer(hits) -> tuple[array, array]:
    """(row numbers, scores) of a served answer; the records' ids are
    ``s:<row>``. Plain arrays: cheap to make in the answering thread, and
    nothing the collector walks."""
    return (array("q", [int(h.chunk.id[2:]) for h in hits]),
            array("d", [h.score for h in hits]))
