"""Device ms a batch charged to the feature extractor, forward and backward."""


def read(s: dict):
    if "fe" not in s["scope_ms"]:
        return None
    return s["scope_ms"]["fe"] / s["batches"]
