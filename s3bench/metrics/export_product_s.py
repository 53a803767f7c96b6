"""``export_product_s``: the program's ``export.product`` spans
(``sparsespatialsampling_torch.trace``): the export's contraction of the
snapshots with the weights (the host's CSR product, or the device's
contraction and its read back); summed over a job's exports and averaged
over the jobs of the traced run.  Nothing to read where the program
records no spans."""


def read(run):
    try:
        from sparsespatialsampling_torch import trace
    except ImportError:
        return None
    records = trace.records()
    if not records or not run.jobs:
        return None
    return sum(r["end_ns"] - r["start_ns"] for r in records
               if r["name"] == "export.product") / 1e9 / len(run.jobs)
