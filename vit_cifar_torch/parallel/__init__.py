"""Data, tensor and expert parallelism over ``torch.distributed``, one
process per device: the mesh and the weight layout (``mesh.py``) and the
collectives the modules and the train step take (``collectives.py``)."""
