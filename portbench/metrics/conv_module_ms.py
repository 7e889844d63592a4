"""Device ms a batch charged to the conformer's conv module (its depthwise conv
included), forward and backward; nothing where no conv module was scoped."""


def read(s: dict):
    if "conv_module" not in s["scope_ms"]:
        return None
    return (s["scope_ms"]["conv_module"] + s["scope_ms"].get("dwconv", 0.0)) / s["batches"]
