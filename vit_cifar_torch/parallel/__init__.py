"""The mesh axes over ``torch.distributed``, one process per device: the
mesh and the weight layout (``mesh.py``), the collectives the modules and
the train step take (``collectives.py``), GPipe over ``pipe``
(``pipeline.py``) and the token stream cut over ``seq``
(``sequence.py``)."""
