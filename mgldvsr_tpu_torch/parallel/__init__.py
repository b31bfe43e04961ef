"""Several processes, one per device, restoring together over
``torch.distributed``: the process group (``mesh.py``) and the
halo-coupled window-parallel sampler (``sharded_sampler.py``).

Counterpart of ``mgldvsr_tpu/parallel/`` for serving. The JAX package runs
one controller over a device mesh; here every device has its own process,
launched by ``torchrun``, and the processes exchange tensors explicitly."""
