"""Data and tensor parallelism over ``torch.distributed``.

Port of ``paa_tpu/parallel/``: ``mesh.py`` lays the ranks ``torchrun``
starts out as the reference's meshes and holds one process group per axis
slice; ``tp.py`` is the Megatron layout of the encoder and the two
autograd functions that carry its collectives.
"""
