"""io: host milliseconds per plane read from the store, from the harness's
span around every slab read of the input view (the port's ``ZarrArray``
read and blosc decode, on the pipeline's reader threads)."""


def read(run):
    spans = run.spans.named("read_slab")
    planes = sum(s[4]["planes"] for s in spans)
    if not planes:
        return None
    return sum(s[3] - s[2] for s in spans) / 1e6 / planes
