"""The card's peak allocated memory over the run (``max_memory_allocated``),
GiB: the step's own footprint as it runs eagerly and is captured, which
its graph's memory pool then holds; the memory that bounds the batch."""


def read(rec):
    b = rec["counts"].get("peak_bytes")
    return b / 2 ** 30 if b else None
