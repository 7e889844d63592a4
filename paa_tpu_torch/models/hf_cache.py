"""Torch-free lookup of pretrained weights in the local Hugging Face hub cache.

The port's copy of the cache half of ``paa_tpu/models/convert.py``
(``_find_cached_weights`` and the read in ``load_hf_checkpoint``): the cache
is ``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
``~/.cache/huggingface/hub``; the snapshot is the one ``refs/main`` names
when it exists, else the newest by mtime; ``model.safetensors`` is taken
before ``pytorch_model.bin``. The files are read by ``checkpoint_io``,
without ``huggingface_hub`` or torch's unpickler.

The reference falls back to ``transformers.from_pretrained`` when the cache
holds no weights. The port has no ``transformers``, so it has no such last
resort: a missing file raises ``FileNotFoundError`` here, and the entry point
then draws random weights (``cli/run_attack.py``).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from paa_tpu_torch.models import checkpoint_io

# the presets' pretrained checkpoints on the hub
HF_REPOS = {
    "wav2vec2-base": "facebook/wav2vec2-base-960h",
    "wav2vec2-large-lv60": "facebook/wav2vec2-large-960h-lv60-self",
    "wav2vec2-conformer-rope-large": "facebook/wav2vec2-conformer-rope-large-960h-ft",
}
WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


def hub_cache_dir() -> str:
    """The hub cache directory, resolved as ``huggingface_hub`` resolves it."""
    home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    return os.environ.get("HF_HUB_CACHE", os.path.join(home, "hub"))


def find_cached_weights(repo: str) -> str | None:
    """Path of ``repo``'s weights file in the hub cache, or None."""
    repo_dir = os.path.join(hub_cache_dir(), "models--" + repo.replace("/", "--"))
    # refs/main names the current revision; a ref to a pruned snapshot must
    # not shadow the others. Snapshot names are commit hashes, so without a
    # ref the newest snapshot wins, not the first in sort order.
    ref = os.path.join(repo_dir, "refs", "main")
    snapshots = []
    if os.path.exists(ref):
        with open(ref) as fh:
            snapshots = [os.path.join(repo_dir, "snapshots", fh.read().strip())]
        snapshots = [s for s in snapshots if os.path.isdir(s)]
    if not snapshots:
        snapshots = sorted(glob.glob(os.path.join(repo_dir, "snapshots", "*")),
                           key=os.path.getmtime, reverse=True)
    for snap in snapshots:
        for fname in WEIGHT_FILES:
            hit = os.path.join(snap, fname)
            if os.path.exists(hit):
                return hit
    return None


def load_cached_state_dict(model_name: str) -> tuple[str, dict[str, np.ndarray]]:
    """(path, HF state dict) of a preset's pretrained weights from the hub
    cache; a name that is no preset is taken as a hub repo id. Raises
    ``FileNotFoundError`` when the cache holds no weights file."""
    repo = HF_REPOS.get(model_name, model_name)
    path = find_cached_weights(repo)
    if path is None:
        raise FileNotFoundError(f"no cached weights for {repo!r} under {hub_cache_dir()}")
    return path, checkpoint_io.load_state_dict(path)
