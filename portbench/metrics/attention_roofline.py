"""The least time of the batches' attention calls (portbench/counts.py) over
the device time charged to the attention scope, in %; nothing where no
device time was charged to it."""


def read(s: dict):
    if not s["scope_ms"].get("attention"):
        return None
    return 100.0 * s["attention_bound_s"] * s["batches"] / (s["scope_ms"]["attention"] / 1e3)
