"""Data and tensor parallelism over `torch.distributed` (counterpart of
maavss_tpu/parallel/): `mesh.py` (the (data, model) layout of the ranks,
the tensor-parallel shape rule, state and batch sharding),
`distributed.py` (joining a torchrun job) and `collectives.py` (the
autograd-aware collectives the layers call)."""
