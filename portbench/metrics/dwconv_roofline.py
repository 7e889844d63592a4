"""The least time of the batches' depthwise-conv calls (the family's
``bounds``) over the device time charged to the depthwise conv's scope, in %;
nothing where no device time was charged to it."""


def read(s: dict):
    if not s["scope_ms"].get("dwconv"):
        return None
    return 100.0 * s["bound_s"]["dwconv"] * s["batches"] / (s["scope_ms"]["dwconv"] / 1e3)
