"""Device ms a batch charged to the encoder (its attention included, its positional
conv not), forward and backward."""


def read(s: dict):
    if "encoder" not in s["scope_ms"]:
        return None
    return (s["scope_ms"]["encoder"] + s["scope_ms"].get("attention", 0.0)) / s["batches"]
