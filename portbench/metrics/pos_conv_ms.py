"""Device ms a batch charged to the positional conv, forward and backward."""


def read(s: dict):
    if "pos_conv" not in s["scope_ms"]:
        return None
    return s["scope_ms"]["pos_conv"] / s["batches"]
