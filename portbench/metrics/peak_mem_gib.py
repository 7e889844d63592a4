"""torch.cuda.max_memory_allocated over the run, in GiB: set-up, window and
all, before the reference runs; nothing off the card."""


def read(s: dict):
    if s["peak_bytes"] is None:
        return None
    return s["peak_bytes"] / 2**30
