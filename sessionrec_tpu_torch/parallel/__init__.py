"""The (data, model) mesh over ``torch.distributed``: one process per rank,
the catalog row-sharded over ``model``, the batch split over ``data``
(counterpart of ``sessionrec_tpu/parallel/``)."""
