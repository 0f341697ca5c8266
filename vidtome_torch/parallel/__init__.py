"""Data and tensor parallelism on ``torch.distributed``: the port's
counterpart of ``vidtome_tpu/parallel/`` (``mesh.py``: the mesh, the TP
layout, the row split and the collectives; ``distributed.py``: the process
group; ``launch.py``: ranks started on one host; ``dryrun.py``: the serving
generation on a mesh of the tiny bundle)."""
