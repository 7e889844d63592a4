"""Device ms a batch charged to the relative conformer's positional inputs (the
biased queries, and the projected tables when they are made), forward and
backward; nothing where no device time was charged to them."""


def read(s: dict):
    if not s["scope_ms"].get("relpos"):
        return None
    return s["scope_ms"]["relpos"] / s["batches"]
