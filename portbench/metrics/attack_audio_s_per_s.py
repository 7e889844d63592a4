"""Seconds of audio put through whole attack epochs per second of the window."""


def read(s: dict):
    return s["clips"] * s["clip_seconds"] / s["window_s"]
